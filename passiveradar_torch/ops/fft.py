"""FFT entry points of the port (counterpart of the JAX package's
ops/mxufft.py).

The JAX package routes power-of-two transforms to an MXU four-step DFT on the
TPU and keeps jnp.fft elsewhere. On the GPU every transform is cuFFT through
``torch.fft``; these functions keep the JAX package's call contracts (pad or
truncate to ``n``, sliced outputs) so the ported call sites read the same.
"""

from __future__ import annotations

import torch


def fft_auto(x: torch.Tensor, n: int | None = None,
             dim: int = -1) -> torch.Tensor:
    """jnp.fft.fft-compatible forward transform (pads or truncates to n)."""
    return torch.fft.fft(x, n=n, dim=dim)


def ifft_auto(x: torch.Tensor, n: int | None = None,
              dim: int = -1) -> torch.Tensor:
    """jnp.fft.ifft-compatible inverse transform (pads or truncates to n)."""
    return torch.fft.ifft(x, n=n, dim=dim)


def dft_matmul(x: torch.Tensor, dim: int = -1, inverse: bool = False,
               n: int | None = None,
               out_len: int | None = None) -> torch.Tensor:
    """The sliced-DFT contract of mxufft.dft_matmul: the ``n``-point
    (i)DFT of ``x`` zero-padded along ``dim``, first ``out_len`` outputs."""
    y = (torch.fft.ifft if inverse else torch.fft.fft)(x, n=n, dim=dim)
    if out_len is not None:
        y = y.narrow(dim, 0, int(out_len))
    return y
