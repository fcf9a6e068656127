"""Candidate-measurement extraction from range-Doppler frames (counterpart of
the JAX package's detect/measurements.py).

Fixed-shape form of the reference's percentile thresholding
(target_detection.py:164-229): instead of a data-dependent nonzero() over
pixels above the 99.8th percentile, a top-k is taken and masked by the same
percentile threshold — the same candidates in strength-sorted order, with
no device-to-host round trip, for one frame or a stack.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of frames whose candidates are extracted at once: extraction makes a
# normalised, reoriented copy of what it reads, so a long stack goes through
# in chunks of at most this size, into outputs allocated once
CHUNK_BYTES = 1 << 28


def _linspace(start: torch.Tensor, stop: torch.Tensor,
              num: int) -> torch.Tensor:
    """start·(1 − i/(num−1)) + stop·i/(num−1), then stop exactly: the
    float32 formula of jnp.linspace, on tensor endpoints."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _percentile_ranks(n: int, percentile: float):
    """jnp.percentile's linear interpolation over n sorted values, in
    float32: the ranks below and above the percentile and their weights,
    (low, high, low_weight, high_weight)."""
    q = np.float32(np.float32(percentile) / np.float32(100.0))
    rank = np.float32(q * np.float32(n - 1))
    low, high = int(np.floor(rank)), int(np.ceil(rank))
    high_weight = np.float32(rank - np.float32(low))
    low_weight = np.float32(np.float32(1.0) - high_weight)
    return low, high, float(low_weight), float(high_weight)


def get_measurements(frame: torch.Tensor, frame_extent, k_max: int = 384,
                     percentile: float = 99.8):
    """Extract strength-sorted candidate (range, Doppler, strength) triples.

    frame: (..., num_doppler, num_range) CFAR maps in the raw pipeline
    orientation, each frame on its own. frame_extent: (doppler_extent_hz,
    range_extent_km) — reference order.

    Matches the reference's geometry: each frame is normalised, reoriented
    with fliplr(frame.T), its persistent-clutter zones zeroed (8 edge range
    rows and ±4 Doppler columns around zero), thresholded at the 99.8th
    percentile (linear interpolation, as jnp.percentile) of the zeroed
    frame. The reference ignores its ``p`` argument and hard-codes 99.8
    (target_detection.py:211); here the parameter is honoured with the same
    default. The percentile's two neighbours in sorted order are among the
    frame's largest values, so the top-k that gives the candidates gives
    them too (taken wider where k_max is not enough): no sort, and a stack
    of any size in one call, each row what its frame gives alone. A stack
    of more than CHUNK_BYTES goes through in chunks of frames, so the
    working copies stay within that size whatever the stack's length.

    Returns (cand, valid): cand is (..., 3, k_max) rows [range_km,
    doppler_hz, strength]; valid (..., k_max) marks entries above
    threshold.
    """
    frame = torch.as_tensor(frame).float()
    extent = torch.as_tensor(frame_extent, dtype=torch.float32,
                             device=frame.device)
    lead, (nf, nr) = frame.shape[:-2], frame.shape[-2:]
    frames = frame.reshape(-1, nf, nr)
    step = max(1, CHUNK_BYTES // (nf * nr * 4))
    if len(frames) <= step:
        cand, valid = _extract(frames, extent, k_max, percentile)
    else:
        cand = torch.empty((len(frames), 3, k_max), dtype=torch.float32,
                           device=frame.device)
        valid = torch.empty((len(frames), k_max), dtype=torch.bool,
                            device=frame.device)
        for s in range(0, len(frames), step):
            cand[s:s + step], valid[s:s + step] = _extract(
                frames[s:s + step], extent, k_max, percentile)
    return cand.reshape(*lead, 3, k_max), valid.reshape(*lead, k_max)


def _extract(frames: torch.Tensor, extent: torch.Tensor, k_max: int,
             percentile: float):
    """get_measurements on (B, nf, nr) frames, in one pass."""
    nf, nr = frames.shape[-2:]
    rpts = _linspace(extent[1], torch.zeros_like(extent[1]), nr)
    dpts = _linspace(-extent[0], extent[0], nf)

    # the mean first, so that its |frame| is freed before the one copy
    mean = frames.abs().mean(dim=(-2, -1), keepdim=True)
    x = frames.transpose(-1, -2).flip(-1)    # (range rows, doppler cols)
    x /= mean
    x[..., :8, :] = 0.0
    x[..., -8:, :] = 0.0
    dc = nf // 2
    x[..., :, dc - 4:dc + 4] = 0.0

    n = nf * nr
    low, high, low_weight, high_weight = _percentile_ranks(n, percentile)
    top, flat = torch.topk(x.reshape(*x.shape[:-2], n), max(k_max, n - low),
                           dim=-1, sorted=True)
    # ascending rank j is descending position n - 1 - j; a NaN sorts first
    # in top-k and, as in jnp.percentile, makes the threshold NaN
    threshold = (top[..., n - 1 - low:n - low] * low_weight
                 + top[..., n - 1 - high:n - high] * high_weight)
    threshold = torch.where(top[..., :1].isnan(), top[..., :1], threshold)

    strength, flat = top[..., :k_max], flat[..., :k_max]
    row = flat // nf                         # range row
    col = flat % nf                          # doppler col
    valid = strength >= threshold
    cand = torch.stack([rpts[row], dpts[col], strength], dim=-2)
    return cand, valid
