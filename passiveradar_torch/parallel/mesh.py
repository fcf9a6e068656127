"""Frame meshes: the devices a frame batch is split over (counterpart of
the JAX package's parallel/mesh.py).

The parallel axis is the CPI-frame axis (the reference's dask chunk axis,
main.py:56-194): frames are data-parallel apart from the 50% CPI overlap,
which becomes a neighbour halo exchange (parallel/halo.py). Where JAX
builds a ``Mesh`` of its devices, a ``FrameMesh`` here is the ordered tuple
of ``torch.device``s that hold the contiguous frame blocks, shard i on
``devices[i]``. A device may appear more than once: two shards on one card
(or on the CPU) run the same halo and transpose code as two cards do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from passiveradar_torch._device import resolve_device


@dataclass(frozen=True)
class FrameMesh:
    """A 1-D mesh: shard i lives on ``devices[i]``."""

    devices: tuple
    axis_name: str = "frames"

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None,
              axis_name: str = "frames") -> FrameMesh:
    """A 1-D mesh over ``devices`` (each resolved by the port's device
    policy), or over the first ``n_devices`` CUDA cards (default: all).

    Raises when CUDA is absent and no devices are named, or when more
    cards are asked for than there are: a mesh never carries on with fewer.
    """
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh: empty device list")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devs)} named")
        return FrameMesh(devs, axis_name)
    resolve_device("cuda")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} CUDA devices asked for, "
                         f"{count} present")
    return FrameMesh(tuple(torch.device("cuda", i) for i in range(n)),
                     axis_name)


def local_mesh(axis_name: str = "frames") -> FrameMesh:
    """A 1-D mesh over every CUDA card of this process.

    The multi-process runtime (parallel/distributed.py) runs one
    independent program per process: process-boundary halos come off disk,
    so no mesh spans processes.
    """
    return make_mesh(axis_name=axis_name)
