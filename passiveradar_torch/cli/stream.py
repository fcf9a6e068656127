"""Streaming-mode CLI: replay a capture through the real-time processor.

    python -m passiveradar_torch.cli.stream --config cfg.yaml [--device cpu]

Port of the JAX package's cli/stream.py: simulates an SDR feed by pushing
the capture's CPI chunks one at a time through StreamingProcessor (CAF →
CFAR → multitarget tracking per push), reports confirmed tracks as they
appear and each push's latency (host clock, from the push to its result on
the host). Wideband configurations are refused until the wideband path is
ported.
"""

from __future__ import annotations

import time

import numpy as np

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import banner, fail_on_missing_capture, \
    load, parser
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.streaming import DETAILS, StreamingProcessor


@fail_on_missing_capture
def main(argv=None):
    """Returns {"frames", "seconds", "push_ms", "tracks"}: ``push_ms`` holds
    the latency of every push that finished a frame, then the flush's;
    ``tracks`` is the last result's track table (or summary)."""
    p = parser("PASSIVE RADAR - STREAMING PROCESSOR (PyTorch)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="Stop after this many frames (default: whole capture)")
    p.add_argument("--tracks", type=int, default=10,
                   help="Multitarget tracker slots")
    p.add_argument("--detail", choices=DETAILS, default="full",
                   help="Per-push result weight: 'summary' skips the "
                        "CAF/CFAR map copy and returns only the track "
                        "summary (the low-latency realtime mode)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device to run on (default: cuda; there is no "
                        "fallback to the CPU)")
    args = p.parse_args(argv)
    cfg = load(args)
    if cfg.wideband_channels >= 2:
        p.error("wideband streaming is not available in the PyTorch port "
                "yet (see ROADMAP.md)")
    dev = resolve_device(args.device)
    banner(cfg, dev)

    reader = CaptureReader(cfg, device=dev)
    total = min(reader.num_frames, cfg.num_frames, args.max_frames
                or reader.num_frames)
    sp = StreamingProcessor(cfg, n_tracks=args.tracks, detail=args.detail,
                            device=dev)
    push_ms, table = [], None

    def timed(fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        return res, (time.perf_counter() - t) * 1e3

    def report(res, ms):
        nonlocal table
        if res is None:
            return
        push_ms.append(ms)
        table = res.summary if res.tracks is None else res.tracks
        status = np.asarray(table["status"])
        est = np.asarray(table["estimate"])
        confirmed = np.where(status == 2)[0]
        msg = ", ".join(
            f"track{i}: {est[i, 0]:.1f} km / {est[i, 1]:+.1f} Hz"
            for i in confirmed) or "no confirmed tracks"
        print(f"frame {res.frame_index:4d}: {msg} ({ms:.1f} ms)", flush=True)

    t0 = time.time()
    try:
        for f in range(total):
            ref, srv = reader.read_iq_frames(f, 1)
            report(*timed(sp.push, ref[0], srv[0]))
        report(*timed(sp.flush))
    finally:
        reader.close()
    dt = time.time() - t0
    lat = (f"; push latency median {np.median(push_ms):.1f} ms, max "
           f"{np.max(push_ms):.1f} ms ({args.detail})") if push_ms else ""
    print(f"Streamed {total} frames in {dt:.1f} s "
          f"({total / dt:.1f} frames/s; capture real-time rate is "
          f"{1 / cfg.frame_interval:.1f} frames/s){lat}")
    return dict(frames=total, seconds=dt, push_ms=push_ms, tracks=table)


if __name__ == "__main__":
    main()
