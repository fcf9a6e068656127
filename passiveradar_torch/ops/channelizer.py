"""Polyphase filter-bank channelizer for wideband illuminators (counterpart
of the JAX package's ops/channelizer.py).

Splits a wideband capture (e.g. an 8 MHz DVB-T-class band, or a band
holding several FM stations) into K critically sampled channels, so each
channel can run its own clutter-cancellation + CAF chain.

Math: with a prototype lowpass h of length K·T (T taps per branch), channel
k of the critically sampled PFB equals ``decimate-by-K(x · e^{-j2πkn/K})``
with h as the anti-alias filter:

    y[m, k] = Σ_p e^{-j2πkp/K} Σ_t h[tK+p] · x[(m-t)K + p]
            = FFT_k( branch-filtered polyphase components )

i.e. a per-branch causal FIR, done as the chain of T shifted elementwise
multiply-adds in the JAX package's order (full float32 products, no
matmul, so no TF32 path), followed by a length-K FFT across branches.
Leading batch axes (frames) ride along.
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device
from passiveradar_torch.ops.fir import design_lowpass


def design_prototype(n_channels: int, taps_per_branch: int = 12,
                     window=("kaiser", 9.0)) -> np.ndarray:
    """Prototype lowpass for a critically sampled K-channel PFB."""
    return design_lowpass(n_channels * taps_per_branch,
                          1.0 / n_channels, window)


def channelize(x, n_channels: int, taps_per_branch: int = 12,
               window=("kaiser", 9.0), device=None) -> torch.Tensor:
    """Split x (..., N) into K critically sampled channels, on x's device
    (numpy: on ``device``, the CUDA card by default).

    Returns (..., N//K, K) complex64; channel k is centred at +k·fs/K
    (negative frequencies at k > K/2, FFT ordering), sampled at fs/K.
    """
    x = on_device(x, device).to(torch.complex64)
    k = int(n_channels)
    t = int(taps_per_branch)
    m_out = x.shape[-1] // k
    # polyphase components: branch p holds samples p, p+K, p+2K, ...
    xb = x[..., :m_out * k].reshape(x.shape[:-1] + (m_out, k))
    # branch filters: h_p[t'] = h[t'K + p]
    hb = torch.from_numpy(design_prototype(k, t, window).reshape(t, k)
                          .astype(np.float32)).to(x.device)
    # y_branch[m, p] = Σ_t' h_p[t'] x[(m-t')K + p], terms in order of t'
    yb = xb * hb[0]
    for i in range(1, min(t, m_out)):
        yb[..., i:, :] += xb[..., :m_out - i, :] * hb[i]
    # channel k (centred at +k·fs/K): Σ_p e^{-j2πkp/K} y_branch[m, p]
    return torch.fft.fft(yb, dim=-1)


def channelize_pair(ref, srv, n_channels: int, device=None, **kw):
    """Channelize both radar channels identically (phase-matched banks)."""
    return (channelize(ref, n_channels, device=device, **kw),
            channelize(srv, n_channels, device=device, **kw))
