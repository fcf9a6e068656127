"""Streaming-mode CLI: replay a capture through the real-time processor.

    python -m passiveradar_torch.cli.stream --config cfg.yaml [--device cpu]
        [--profile DIR]

Port of the JAX package's cli/stream.py: simulates an SDR feed by pushing
the capture's CPI chunks one at a time through StreamingProcessor (CAF →
CFAR → multitarget tracking per push), reports confirmed tracks as they
appear and each push's latency (host clock, from the push to its result on
the host). A wideband configuration (``wideband_channels: K``) streams
through WidebandStreamingProcessor instead: one push per wideband CPI,
reported per selected channel, with no flush (wideband CPIs do not
overlap). ``--profile DIR`` writes a torch.profiler Chrome trace of the
pushes into DIR, each a ``push`` span with its upload, launch and fetch
(``passiveradar_torch/spans.py``).
"""

from __future__ import annotations

import time

import numpy as np

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, add_profile, \
    banner, fail_on_missing_capture, load, parser, profiled
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.streaming import DETAILS, StreamingProcessor


@fail_on_missing_capture
def main(argv=None):
    """Returns {"frames", "seconds", "push_ms", "tracks"}: ``push_ms`` holds
    the latency of every push that finished a frame, then the flush's;
    ``tracks`` is the last result's track table (or summary), and for a
    wideband configuration {channel: that channel's last table}."""
    p = parser("PASSIVE RADAR - STREAMING PROCESSOR (PyTorch)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="Stop after this many frames (default: whole capture)")
    p.add_argument("--tracks", type=int, default=10,
                   help="Multitarget tracker slots")
    p.add_argument("--detail", choices=DETAILS, default="full",
                   help="Per-push result weight: 'summary' skips the "
                        "CAF/CFAR map copy and returns only the track "
                        "summary (the low-latency realtime mode)")
    add_profile(p)
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    dev = resolve_device(args.device)
    banner(cfg, dev)

    reader = CaptureReader(cfg, device=dev)
    total = min(reader.num_frames, cfg.num_frames, args.max_frames
                or reader.num_frames)
    wideband = cfg.wideband_channels >= 2
    if wideband:
        from passiveradar_torch.wideband import WidebandStreamingProcessor
        sp = WidebandStreamingProcessor(cfg, n_tracks=args.tracks,
                                        detail=args.detail, device=dev)
        print(f"Wideband streaming: {cfg.wideband_channels} channels, "
              f"tracking on {list(cfg.wideband_channel_select)}")
    else:
        sp = StreamingProcessor(cfg, n_tracks=args.tracks,
                                detail=args.detail, device=dev)
    push_ms, tables = [], {}

    def timed(fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        return res, (time.perf_counter() - t) * 1e3

    def report(res, ms, channel=None):
        table = res.summary if res.tracks is None else res.tracks
        tables[channel] = table
        status = np.asarray(table["status"])
        est = np.asarray(table["estimate"])
        confirmed = np.where(status == 2)[0]
        msg = ", ".join(
            f"track{i}: {est[i, 0]:.1f} km / {est[i, 1]:+.1f} Hz"
            for i in confirmed) or "no confirmed tracks"
        label = "" if channel is None else f" ch{channel}"
        print(f"frame {res.frame_index:4d}{label}: {msg} ({ms:.1f} ms)",
              flush=True)

    def pushed(res, ms):
        if res is None:
            return
        push_ms.append(ms)
        if wideband:
            for k, r in res.items():
                report(r, ms, k)
        else:
            report(res, ms)

    t0 = time.time()
    try:
        with profiled(args.profile, dev):
            for f in range(total):
                ref, srv = reader.read_iq_frames(f, 1)
                pushed(*timed(sp.push, ref[0], srv[0]))
            if not wideband:
                pushed(*timed(sp.flush))
    finally:
        reader.close()
    dt = time.time() - t0
    lat = (f"; push latency median {np.median(push_ms):.1f} ms, max "
           f"{np.max(push_ms):.1f} ms ({args.detail})") if push_ms else ""
    print(f"Streamed {total} frames in {dt:.1f} s "
          f"({total / dt:.1f} frames/s; capture real-time rate is "
          f"{1 / cfg.frame_interval:.1f} frames/s){lat}")
    if args.profile:
        print(f"Profiler trace written into {args.profile}")
    return dict(frames=total, seconds=dt, push_ms=push_ms,
                tracks=tables if wideband else tables.get(None))


if __name__ == "__main__":
    main()
