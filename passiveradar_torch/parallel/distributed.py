"""Multi-process execution (counterpart of the JAX package's
parallel/distributed.py).

One Python process per host (or per card), all running the same program.
The capture's frame axis is split contiguously across processes: each
process's CaptureReader serves only its range (io/hdf5.CaptureReader.shard)
and reads one frame of margin into each neighbouring range, so the halo
frame at a process boundary comes off disk and is recomputed exactly. The
hot path therefore needs no communication between processes: each runs
``run_capture`` on its own card at its own pace and writes
``<output>.partN.<ftype>``, and the processes meet once at the end, in one
all-gather of their frame counts that doubles as the barrier; process 0
then writes the metadata of the global stack. ``io.writers.concat_parts``
and ``cli.concat`` reassemble the parts.

That gather runs over ``torch.distributed`` with the gloo backend: it
needs no card, so several processes can share one card (NCCL puts no two
ranks on one GPU) and the CPU tests run the same code. Each process takes
card ``rank % device_count`` unless told otherwise.

The JAX package's ``global_frame_array`` (a globally sharded array built
from each host's frames) has no counterpart: torch has no globally sharded
tensor, and no entry point uses it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the process group (a no-op for one process).

    ``coordinator_address`` is ``host:port`` of process 0, which listens
    there. With no arguments, a launcher's environment (torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) is used
    when it names more than one process, where JAX detects a TPU pod.
    Returns once every process has joined, as jax.distributed.initialize
    does: gloo connects its pairs lazily, so without that barrier a process
    that leaves soon after could close a pair its peer is still opening.
    """
    if num_processes is not None and num_processes > 1:
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(f"process_id must be in [0, {num_processes}) "
                             f"for {num_processes} processes, got "
                             f"{process_id}")
        if coordinator_address is None:
            raise ValueError("num_processes > 1 needs a coordinator "
                             "address host:port")
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        dist.barrier()
    elif coordinator_address is not None and num_processes is None:
        # a coordinator without a process count cannot be resolved:
        # running single-process here would quietly process the whole
        # capture in each process (an explicit num_processes=1 is a valid
        # single-process run)
        raise ValueError(
            "coordinator_address given without num_processes; pass "
            "--num-processes/--process-id too (or neither, under a "
            "launcher that sets RANK and WORLD_SIZE)")
    elif num_processes is None and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        dist.init_process_group("gloo")
        dist.barrier()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def part_path(cfg: RadarConfig, process_index: int) -> str:
    """Per-process output stack path (a contiguous frame range)."""
    return (f"{cfg.output_fname}.part{process_index}"
            f".{cfg.range_doppler_map_ftype}")


def process_device(device=None) -> torch.device:
    """This process's device: ``device`` when given, else card
    ``rank % device_count`` (several processes may share a card)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def run_capture_multihost(cfg: RadarConfig, capture_path: str | None = None,
                          output_path: str | None = None,
                          batch_frames: int | None = None,
                          progress: bool = True, device=None):
    """Process a capture across every process of the current group.

    Each process reads its own contiguous frame range (with one-frame disk
    margins at interior edges, so boundary halos are exact) and runs
    run_capture on its device (process_device). With more than one process
    its maps land in part_path(cfg, rank); process 0 writes metadata
    describing the global stack. Returns (local_frames, global_frames).
    """
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.io.writers import MapWriter, write_metadata
    from passiveradar_torch.pipeline import run_capture

    dev = process_device(device)
    rank, count = process_index(), process_count()
    reader = CaptureReader(cfg, capture_path, device=dev)
    try:
        if count > 1:
            # shard AFTER applying cfg.num_frames: the cap bounds the whole
            # capture, not each range. Data beyond the cap stays a real
            # halo margin of the last range (as in a single-process run).
            capped = min(reader.num_frames, cfg.num_frames)
            extra_after = reader.num_frames > capped
            reader.num_frames = capped
            reader.shard(rank, count)
            if extra_after and rank == count - 1:
                reader.frame_margin_after = True
            if output_path is None:
                output_path = part_path(cfg, rank)
        writer = MapWriter(cfg, min(reader.num_frames, cfg.num_frames),
                           output_path)
        try:
            n = run_capture(reader, writer, cfg, batch_frames=batch_frames,
                            progress=progress, device=dev)
        finally:
            writer.close()
    finally:
        reader.close()
    if count > 1:
        # the metadata describes the global stack; every process takes part
        # in the gather, which is also the end-of-run barrier
        counts = [None] * count
        dist.all_gather_object(counts, n)
        global_n = int(sum(counts))
    else:
        global_n = n
    if rank == 0:
        write_metadata(cfg, global_n)
    return n, global_n
