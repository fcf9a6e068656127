"""FFT entry points of the port (counterpart of the JAX package's
ops/mxufft.py).

``fft_auto`` / ``ifft_auto`` keep the JAX call contracts (pad or truncate to
``n``) and, as there, send every power-of-two transform of at least
``AUTO_MIN`` samples to ``fft`` / ``ifft``. Those take the fused four-step
kernel of ops/fft_kernel.py when ``PASSIVERADAR_PALLAS_FFT`` opts in and the
length is in its split table (2^14 … 2^18), and cuFFT through ``torch.fft``
otherwise; shorter transforms always go to ``torch.fft``. The JAX package's
MXU four-step (``_core``) and its ``use_mxu`` gate exist because the TPU's
native FFT is slow; they have no counterpart here.
"""

from __future__ import annotations

import torch

from passiveradar_torch.ops import fft_kernel

# fft_auto's routing threshold, as in the JAX package
AUTO_MIN = 65536


def _transform(x: torch.Tensor, dim: int, inverse: bool) -> torch.Tensor:
    n = x.shape[dim]
    if n & (n - 1):
        raise ValueError(f"fft/ifft take power-of-two lengths only, got {n}")
    if fft_kernel.supported(n) and fft_kernel.use_fused():
        y = fft_kernel.fft_fused(x.movedim(dim, -1), inverse=inverse)
        return y.movedim(-1, dim)
    return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=dim)


def fft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Forward DFT along ``dim`` (power-of-two length)."""
    return _transform(x, dim, False)


def ifft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse DFT along ``dim`` (power-of-two length)."""
    return _transform(x, dim, True)


def _pad_to(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    cur = x.shape[dim]
    if cur >= n:
        return x.narrow(dim, 0, n)
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, n - cur]
    return torch.nn.functional.pad(x, pad)


def _auto(x: torch.Tensor, n: int | None, dim: int,
          inverse: bool) -> torch.Tensor:
    if n is not None:
        x = _pad_to(x, int(n), dim)
    m = x.shape[dim]
    if m & (m - 1) == 0 and m >= AUTO_MIN:
        return _transform(x, dim, inverse)
    return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=dim)


def fft_auto(x: torch.Tensor, n: int | None = None,
             dim: int = -1) -> torch.Tensor:
    """jnp.fft.fft-compatible forward transform (pads or truncates to n)."""
    return _auto(x, n, dim, False)


def ifft_auto(x: torch.Tensor, n: int | None = None,
              dim: int = -1) -> torch.Tensor:
    """jnp.fft.ifft-compatible inverse transform (pads or truncates to n)."""
    return _auto(x, n, dim, True)


def dft_matmul(x: torch.Tensor, dim: int = -1, inverse: bool = False,
               n: int | None = None,
               out_len: int | None = None) -> torch.Tensor:
    """The sliced-DFT contract of mxufft.dft_matmul: the ``n``-point
    (i)DFT of ``x`` zero-padded along ``dim``, first ``out_len`` outputs."""
    y = (torch.fft.ifft if inverse else torch.fft.fft)(x, n=n, dim=dim)
    if out_len is not None:
        y = y.narrow(dim, 0, int(out_len))
    return y
