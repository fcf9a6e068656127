"""Candidate-measurement extraction from range-Doppler frames (counterpart of
the JAX package's detect/measurements.py).

Fixed-shape form of the reference's percentile thresholding
(target_detection.py:164-229): instead of a data-dependent nonzero() over
pixels above the 99.8th percentile, a top-k is taken and masked by the same
percentile threshold — the same candidates in strength-sorted order, with
no device-to-host round trip.
"""

from __future__ import annotations

import torch


def _linspace(start: torch.Tensor, stop: torch.Tensor,
              num: int) -> torch.Tensor:
    """start·(1 − i/(num−1)) + stop·i/(num−1), then stop exactly: the
    float32 formula of jnp.linspace, on tensor endpoints."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def get_measurements(frame: torch.Tensor, frame_extent, k_max: int = 384,
                     percentile: float = 99.8):
    """Extract strength-sorted candidate (range, Doppler, strength) triples.

    frame: (num_doppler, num_range) CFAR map in the raw pipeline orientation.
    frame_extent: (doppler_extent_hz, range_extent_km) — reference order.

    Matches the reference's geometry: the frame is normalised, reoriented
    with fliplr(frame.T), its persistent-clutter zones zeroed (8 edge range
    rows and ±4 Doppler columns around zero), thresholded at the 99.8th
    percentile (linear interpolation, as jnp.percentile) of the zeroed
    frame. The reference ignores its ``p`` argument and hard-codes 99.8
    (target_detection.py:211); here the parameter is honoured with the same
    default.

    Returns (cand, valid): cand is (3, k_max) rows [range_km, doppler_hz,
    strength]; valid marks entries above threshold.
    """
    frame = torch.as_tensor(frame).float()
    extent = torch.as_tensor(frame_extent, dtype=torch.float32,
                             device=frame.device)
    nf, nr = frame.shape

    rpts = _linspace(extent[1], torch.zeros_like(extent[1]), nr)
    dpts = _linspace(-extent[0], extent[0], nf)

    x = frame / frame.abs().mean()
    x = torch.fliplr(x.T).clone()            # (range rows, doppler cols)
    x[:8, :] = 0.0
    x[-8:, :] = 0.0
    dc = nf // 2
    x[:, dc - 4:dc + 4] = 0.0

    flat_x = x.reshape(-1)
    threshold = torch.quantile(flat_x, percentile / 100.0,
                               interpolation="linear")

    strength, flat = torch.topk(flat_x, k_max, sorted=True)
    row = flat // nf                         # range row
    col = flat % nf                          # doppler col
    valid = strength >= threshold
    cand = torch.stack([rpts[row], dpts[col], strength])
    return cand, valid
