"""CPI-overlap halo along the frame axis (counterpart of
the JAX package's parallel/halo.py).

The reference builds 50%-overlapped CPIs with dask's
``da.overlap.overlap(depth=cpi_samples//4, boundary=0)`` (main.py:178-181):
every frame is extended with ``depth`` samples from each neighbour, zero at
the capture edges. The multi-GPU neighbour exchange waits for a later slice.
"""

from __future__ import annotations

import torch


def overlap_frames(x: torch.Tensor, depth: int) -> torch.Tensor:
    """(F, C) → (F, C + 2·depth): frame f gets the tail of f−1 and the head
    of f+1; zero boundary at the first and last frame."""
    z = torch.zeros((1, depth), dtype=x.dtype, device=x.device)
    left = torch.cat([z, x[:-1, -depth:]], dim=0)
    right = torch.cat([x[1:, :depth], z], dim=0)
    return torch.cat([left, x, right], dim=1)
