"""CPI-overlap halo along the frame axis (counterpart of
the JAX package's parallel/halo.py).

The reference builds 50%-overlapped CPIs with dask's
``da.overlap.overlap(depth=cpi_samples//4, boundary=0)`` (main.py:178-181):
every frame is extended with ``depth`` samples from each neighbour, zero at
the capture edges. Over a frame mesh (parallel/mesh.py) the frame axis is
split into contiguous blocks, one a shard, and the same operation is a
neighbour exchange:

* ``overlap_frames``: the whole (F, C) array on one device;
* ``local_overlap``: the per-shard blocks, each shard's edge halos copied
  from its neighbours' blocks onto its own device (the JAX package's two
  ``lax.ppermute``s, one a direction): ``exchange_edges``, then
  ``with_halo`` on each shard;
* ``overlap_frames_shmap``: split, exchange, concatenate.

All three are bit-identical (tested).
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


def local_overlap(blocks, depth: int) -> list:
    """The halo over per-shard blocks: ``blocks`` are the (f_local, C)
    blocks of the frame axis in frame order, each on its shard's device;
    returns their (f_local, C + 2·depth) blocks, each on its own device:
    ``with_halo`` of each block and its ``exchange_edges``."""
    return [with_halo(x, *edges)
            for x, edges in zip(blocks, exchange_edges(blocks, depth))]


def exchange_edges(blocks, depth: int) -> list:
    """The exchange of ``local_overlap``: for each block, the (1, depth)
    halos (from_left, from_right) on its device. The tail of each block's
    last frame goes to the next shard and the head of its first frame to
    the previous one (``non_blocking`` copies); the capture edges get
    zeros. ``local_overlap.exchanges`` counts one exchange a direction a
    call, as the JAX package's one ppermute a direction."""
    n = len(blocks)
    tails = [b[-1:, -depth:] for b in blocks]
    heads = [b[:1, :depth] for b in blocks]
    local_overlap.exchanges += 2
    out = []
    for i, xl in enumerate(blocks):
        z = torch.zeros((1, depth), dtype=xl.dtype, device=xl.device)
        from_left = tails[i - 1].to(xl.device, non_blocking=True) \
            if i > 0 else z
        from_right = heads[i + 1].to(xl.device, non_blocking=True) \
            if i < n - 1 else z
        out.append((from_left, from_right))
    return out


def with_halo(x: torch.Tensor, from_left: torch.Tensor,
              from_right: torch.Tensor) -> torch.Tensor:
    """One shard's (f_local, C) block → (f_local, C + 2·depth), given the
    (1, depth) halos that ``exchange_edges`` brought it."""
    depth = from_left.shape[1]
    left = torch.cat([from_left, x[:-1, -depth:]], dim=0)
    right = torch.cat([x[1:, :depth], from_right], dim=0)
    return torch.cat([left, x, right], dim=1)


local_overlap.exchanges = 0


def split_frames(x: torch.Tensor, mesh) -> list:
    """(F, ...) → ``len(mesh)`` contiguous frame blocks, block i on
    ``mesh.devices[i]`` (``non_blocking`` copies). F must divide the mesh."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} frames do not divide the {n}-shard "
                         f"'{mesh.axis_name}' mesh")
    return [b.to(dev, non_blocking=True)
            for b, dev in zip(torch.chunk(x, n, dim=0), mesh.devices)]


def overlap_frames_shmap(x: torch.Tensor, depth: int, mesh) -> torch.Tensor:
    """overlap_frames with the frame axis split over ``mesh``: the blocks'
    halos exchanged by local_overlap and the result gathered on ``x``'s
    device. Bit-identical to overlap_frames (tested)."""
    blocks = local_overlap(split_frames(x, mesh), depth)
    return torch.cat([b.to(x.device) for b in blocks], dim=0)
