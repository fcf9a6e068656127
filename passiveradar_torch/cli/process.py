"""Main processing entry point: capture → range-Doppler map stack.

    python -m passiveradar_torch.cli.process --config cfg.yaml [--device cpu]

Port of the JAX package's cli/process.py (reference main.py:17-28,
229-233) for one device: the CUDA card by default, the CPU on request.
"""

from __future__ import annotations

import time

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, banner, \
    fail_on_missing_capture, load, parser
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.io.writers import MapWriter, write_metadata
from passiveradar_torch.pipeline import capture_frame_count, run_capture

# flags of the JAX CLI that this port does not carry yet (see ROADMAP.md)
_NOT_PORTED = ("--dispatch-groups", "--shard", "--profile", "--num-processes",
               "--process-id", "--coordinator")


@fail_on_missing_capture
def main(argv=None):
    p = parser("PASSIVE RADAR - MAIN PROCESSING (PyTorch)")
    p.add_argument("--batch-frames", type=int, default=None,
                   help="Frames per device batch (default: cfg.frame_batch)")
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted run from the existing output "
                        "file")
    add_device(p)
    for flag in _NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help="not available in the PyTorch port yet")
    args = p.parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{flag} is not available in the PyTorch port yet "
                    "(see ROADMAP.md)")
    cfg = load(args)
    dev = resolve_device(args.device)
    banner(cfg, dev)

    reader = CaptureReader(cfg, device=dev)
    print(f"Corrected a sample offset of {reader.offset} samples between "
          "channels")
    total = capture_frame_count(reader, cfg)
    writer = MapWriter(cfg, total, resume=args.resume)
    if args.resume and writer.frames_done:
        print(f"Resuming at frame {writer.frames_done}/{total}")
    t0 = time.time()
    try:
        n = run_capture(reader, writer, cfg, batch_frames=args.batch_frames,
                        device=dev)
    finally:
        writer.close()
        reader.close()
    write_metadata(cfg, n)
    dt = time.time() - t0
    print(f"Saved {n} range-Doppler frames to {writer.path} "
          f"({n / dt:.1f} frames/s); metadata in {cfg.meta_fname}")
    return n


if __name__ == "__main__":
    main()
