"""Digital-phosphor persistence effect (counterpart of the JAX package's
viz/persistence.py).

Reference semantics (plotting_tools.py:9-30): display frame k is the decayed
sum of the last ``hold`` frames, frame k-i weighted by decay**i.

The JAX package evaluates the whole stack as one causal depthwise
convolution over the frame axis. Here it is an accumulation over the
``hold`` shifted copies of the stack, oldest term first, as the causal
window runs: ``hold`` elementwise float32 multiply-adds per pixel, with no
matmul or cuDNN convolution in the sum, so no TF32 setting can reach it
(on a 1024 × 177 FM frame a TF32 sum would move the display's colour
limits). Each pass reads the stack once; at the renderer's chunk size this
is a few milliseconds on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device


def _weights(decay, n: int, device) -> torch.Tensor:
    """decay**i for i < n as float32 (computed in float64, rounded once)."""
    w = np.float64(np.float32(decay)) ** np.arange(n, dtype=np.float64)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def persistence(x, k: int, hold: int, decay: float,
                device=None) -> torch.Tensor:
    """Single output frame k of the persistence effect.

    x: (H, W, F) frame stack (the reference's layout): a tensor, which stays
    on its device unless ``device`` is given, or numpy, which goes to
    ``device`` (default: the CUDA card). Matches
    plotting_tools.persistence(X, k, hold, decay).
    """
    x = on_device(x, device).float()
    n = min(k + 1, hold)
    w = _weights(decay, n, x.device)
    out = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    for i in range(n - 1, -1, -1):          # oldest frame first
        out = out + x[:, :, k - i] * w[i]
    return out


def persistence_stack(frames: torch.Tensor, hold: int,
                      decay) -> torch.Tensor:
    """All persistence frames at once. frames: (F, H, W) float32 tensor →
    (F, H, W) on its device.

    out[k] = Σ_{i<min(k+1,hold)} frames[k-i]·decay^i: the causal window's
    terms added oldest first (term i is the stack shifted by i frames,
    zero before the first frame).
    """
    frames = frames.float()
    f = frames.shape[0]
    w = _weights(decay, hold, frames.device)
    out = torch.zeros_like(frames)
    for i in range(min(hold, f) - 1, -1, -1):
        out[i:] += frames[:f - i] * w[i]
    return out
