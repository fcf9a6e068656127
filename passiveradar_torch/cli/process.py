"""Main processing entry point: capture → range-Doppler map stack.

    python -m passiveradar_torch.cli.process --config cfg.yaml [--device cpu]
        [--batch-frames N] [--dispatch-groups G] [--shard] [--resume]
        [--profile DIR]
        [--num-processes P --process-id I --coordinator HOST:PORT]

Port of the JAX package's cli/process.py (reference main.py:17-28,
229-233): the CUDA card by default, the CPU on request. ``--shard`` splits
each batch over every local card (over the one device with ``--device
cpu``); the multi-process flags run one contiguous frame range a process,
each on card ``rank % device_count`` (so several processes may share a
card), into ``.partN`` stacks that ``cli.concat`` merges.
"""

from __future__ import annotations

import time

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, add_profile, \
    banner, fail_on_missing_capture, load, parser, profiled, shard_mesh
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.io.writers import MapWriter, write_metadata
from passiveradar_torch.pipeline import capture_frame_count, run_capture


def run_multiprocess(cfg, args) -> int:
    """One process of a multi-process run; returns its local frame count."""
    import torch.distributed as dist

    from passiveradar_torch.parallel.distributed import (
        init_distributed, process_count, process_device, process_index,
        run_capture_multihost)
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        # --device cuda (the default) lets each process take its own card
        dev = process_device(None if args.device == "cuda" else args.device)
        first = process_index() == 0
        if first:
            banner(cfg, dev)
        t0 = time.time()
        n, global_n = run_capture_multihost(
            cfg, batch_frames=args.batch_frames, progress=first, device=dev)
        dt = time.time() - t0
        print(f"[process {process_index()}] {n} frames "
              f"({n / dt:.1f} frames/s local); {global_n} frames globally")
        if first and process_count() > 1:
            print("Reassemble the part stacks with: python -m "
                  "passiveradar_torch.cli.concat --config <config>")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return n


@fail_on_missing_capture
def main(argv=None):
    """Returns the number of frames this process wrote."""
    p = parser("PASSIVE RADAR - MAIN PROCESSING (PyTorch)")
    p.add_argument("--batch-frames", type=int, default=None,
                   help="Frames per device batch (default: cfg.frame_batch)")
    p.add_argument("--dispatch-groups", type=int, default=1,
                   help="Taken for the JAX CLI's flags (at least 1); the "
                        "port runs one batch a call whatever G is")
    p.add_argument("--shard", action="store_true",
                   help="Split each batch over every local CUDA card (over "
                        "the one device with --device cpu)")
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted run from the existing output "
                        "file")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process: total process count; each process "
                        "writes a .partN output stack")
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-process: this process's index")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process: host:port of process 0")
    add_profile(p)
    add_device(p)
    args = p.parse_args(argv)
    if args.dispatch_groups < 1:
        p.error("--dispatch-groups must be at least 1")
    cfg = load(args)

    if args.num_processes is not None or args.coordinator is not None:
        return run_multiprocess(cfg, args)

    dev = resolve_device(args.device)
    banner(cfg, dev)
    mesh = shard_mesh(dev) if args.shard else None
    if mesh is not None:
        print(f"Sharding each batch over {len(mesh)} device(s)")

    reader = CaptureReader(cfg, device=dev)
    print(f"Corrected a sample offset of {reader.offset} samples between "
          "channels")
    total = capture_frame_count(reader, cfg)
    writer = MapWriter(cfg, total, resume=args.resume)
    if args.resume and writer.frames_done:
        print(f"Resuming at frame {writer.frames_done}/{total}")
    t0 = time.time()
    try:
        with profiled(args.profile, dev):
            n = run_capture(reader, writer, cfg,
                            batch_frames=args.batch_frames, device=dev,
                            dispatch_groups=args.dispatch_groups, mesh=mesh)
    finally:
        writer.close()
        reader.close()
    write_metadata(cfg, n)
    dt = time.time() - t0
    print(f"Saved {n} range-Doppler frames to {writer.path} "
          f"({n / dt:.1f} frames/s); metadata in {cfg.meta_fname}")
    if args.profile:
        print(f"Profiler trace written into {args.profile}")
    return n


if __name__ == "__main__":
    main()
