"""Partial and sparse FFTs (counterpart of the JAX package's ops/zoomfft.py).

The clutter loop needs only the first m lags of its N-point inverse
transforms and transforms tap vectors with m nonzero entries. The JAX
package splits those into block-sized transforms to save TPU HBM passes; on
the GPU they are one cuFFT call plus a slice or a zero pad, with the same
contracts.
"""

from __future__ import annotations

import torch


def partial_ifft(x: torch.Tensor, m_out: int) -> torch.Tensor:
    """First ``m_out`` outputs of ifft(x) along the last axis."""
    return torch.fft.ifft(x, dim=-1)[..., :m_out]


def sparse_fft(s: torch.Tensor, n: int) -> torch.Tensor:
    """Full n-point FFT of a signal whose support is its first len(s)
    samples (len(s) <= n)."""
    if s.shape[-1] > n:
        raise ValueError(f"support {s.shape[-1]} longer than n={n}")
    return torch.fft.fft(s, n=n, dim=-1)
