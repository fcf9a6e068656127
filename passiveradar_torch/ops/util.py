"""Small signal utilities shared across the pipeline."""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device


def deinterleave_batch(raw: torch.Tensor) -> torch.Tensor:
    """(F, L) real interleaved IQ → (F, L//2) complex64 (L even)."""
    return torch.complex(raw[:, 0::2].float(), raw[:, 1::2].float())


def iq_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., n) complex64 or (..., n, 2) float IQ pairs → contiguous
    (..., n, 2) float32 pairs (the resampler kernel's input layout)."""
    if x.is_complex():
        return torch.view_as_real(x.to(torch.complex64).contiguous())
    return x.float().contiguous()


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) float IQ pairs or complex → complex64."""
    if x.is_complex():
        return x.to(torch.complex64)
    return torch.view_as_complex(x.float().contiguous())


def to_host_complex(x) -> np.ndarray:
    """A (complex) tensor as host numpy; numpy arrays pass through."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def deinterleave_iq(x, device=None) -> torch.Tensor:
    """Interleaved real IQ [I0, Q0, I1, Q1, ...] → complex64 along the last
    axis, with the reference's ``[0:-1:2]`` quirk (signal_utils.py:19-22):
    an odd-length input loses its final I sample; an even one gives
    exactly len//2 samples. Numpy goes to ``device`` (the CUDA card by
    default)."""
    x = on_device(x, device)
    i = x[..., 0:-1:2]
    q = x[..., 1::2]
    n = min(i.shape[-1], q.shape[-1])
    return torch.complex(i[..., :n].float(), q[..., :n].float())


def normalize(x, device=None) -> torch.Tensor:
    """``x`` over its mean magnitude (signal_utils.py:7-9)."""
    x = on_device(x, device)
    return x / x.abs().mean()


def shift(x, n: int, device=None) -> torch.Tensor:
    """``x`` shifted by ``n`` samples along the last axis, the vacated edge
    zero-filled (signal_utils.py:34-47)."""
    x = on_device(x, device)
    n = int(n)
    if n == 0:
        return x
    pad = (n, 0) if n > 0 else (0, -n)
    body = x[..., :-n] if n > 0 else x[..., -n:]
    return torch.nn.functional.pad(body, pad)
