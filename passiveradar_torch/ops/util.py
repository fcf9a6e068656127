"""Small signal utilities shared across the pipeline."""

from __future__ import annotations

import numpy as np
import torch


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
