"""scipy.signal.decimate's default IIR path (cheby1 filtfilt) in torch.

Port of the JAX package's ops/iir.py, used by the channel-offset search
(reference signal_utils.py:75-77, main.py:54). The order-8 Chebyshev-I
transfer function is split host-side into first-order partial fractions
(``scipy.signal.residuez``), H(z) = k0 + Σ_i r_i/(1 − p_i z⁻¹), so each pole
is the recurrence w_i[n] = p_i·w_i[n−1] + r_i·x[n]. At narrow cutoffs the
flat split is ill-conditioned in complex64 and the filter runs instead as
the biquad cascade, each section split into its own two poles.

Every recurrence goes through ``_first_order_scan``: a log-depth
(Hillis-Steele) doubling scan over the whole signal, w[k] += p^s·w[k−s] for
s = 1, 2, 4, …, with the powers p^s from float64 host arithmetic — about
log2(n) full-array passes instead of the JAX package's blocked lax.scan of
4096 sequential steps, which eager torch would launch one by one.

filtfilt's edge handling is exact: odd extension of 27 samples per side and
``lfilter_zi`` steady-state initial conditions (per pole, u0/(1−p) for a
constant drive u0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import signal as _spsignal

_ORDER = 8
_PADLEN = 3 * (_ORDER + 1)   # scipy filtfilt default: 3*max(len(a), len(b))


def _first_order_scan(u: torch.Tensor, p64: np.ndarray,
                      w0: torch.Tensor) -> torch.Tensor:
    """w[n] = p·w[n−1] + u[n] with w[−1] = w0, batched over poles.

    u: (P, n) complex64; p64: (P,) complex128 poles; w0: (P,) complex64.
    """
    n = u.shape[1]
    p = torch.from_numpy(p64.astype(np.complex64)).to(u.device)
    w = u.clone()
    w[:, 0] += p * w0
    s = 1
    while s < n:
        ps = torch.from_numpy((p64 ** s).astype(np.complex64)).to(u.device)
        w = torch.cat([w[:, :s], w[:, s:] + ps[:, None] * w[:, :-s]], dim=1)
        s *= 2
    return w


@functools.lru_cache(maxsize=32)
def _cheby1_partial_fractions(q: int):
    """Host float64 design: residues, poles, direct term for factor q."""
    b, a = _spsignal.cheby1(_ORDER, 0.05, 0.8 / q)
    r, p, k = _spsignal.residuez(b, a)
    k0 = complex(k[0]) if len(k) else 0.0
    return (np.asarray(r, np.complex128), np.asarray(p, np.complex128), k0)


@functools.lru_cache(maxsize=32)
def _cheby1_sections(q: int):
    """Biquad cascade, each section split into 2-pole partial fractions:
    (b_taps(3,), poles(2,), residues(2,)) per section, float64 host."""
    sos = _spsignal.cheby1(_ORDER, 0.05, 0.8 / q, output="sos")
    out = []
    for b0, b1, b2, _, a1, a2 in sos:
        lam, mu = np.roots([1.0, a1, a2])
        out.append((np.array([b0, b1, b2], np.float64),
                    np.array([lam, mu], np.complex128),
                    np.array([lam / (lam - mu), mu / (mu - lam)],
                             np.complex128)))
    return tuple(out)


def _c64(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.complex64)).to(device)


def _plfilter_flat(x: torch.Tensor, q: int) -> torch.Tensor:
    """lfilter(b, a, x, zi=lfilter_zi(b, a)·x[0]) via the flat 8-pole split."""
    r64, p64, k0 = _cheby1_partial_fractions(q)
    u = _c64(r64, x.device)[:, None] * x[None, :]
    w0 = x[0] * _c64(r64 / (1.0 - p64), x.device)
    w = _first_order_scan(u, p64, w0)
    return complex(np.complex64(k0)) * x + w.sum(0)


def _plfilter_cascade(x: torch.Tensor, q: int) -> torch.Tensor:
    """Same contract via the biquad cascade (well-conditioned at narrow
    cutoffs); each section's history level is its own x[0]."""
    y = x
    for b_t, p64, r64 in _cheby1_sections(q):
        x0 = y[:1]
        ym1 = torch.cat([x0, y[:-1]])
        ym2 = torch.cat([x0, x0, y[:-2]])
        f = (float(np.float32(b_t[0])) * y + float(np.float32(b_t[1])) * ym1
             + float(np.float32(b_t[2])) * ym2)
        u = _c64(r64, x.device)[:, None] * f[None, :]
        f_ss = x0[0] * float(np.float32(b_t.sum()))
        w0 = f_ss * _c64(r64 / (1.0 - p64), x.device)
        y = _first_order_scan(u, p64, w0).sum(0)
    return y


def iir_decimate(x: torch.Tensor, q: int) -> torch.Tensor:
    """scipy.signal.decimate(x, q) with the default zero-phase cheby1 IIR
    filter, for a 1-D tensor. As in scipy the 0.8-Nyquist filter runs even
    at q == 1 (pure filtering), which the reference's offset search uses.
    """
    n = x.shape[0]
    if n <= _PADLEN:
        raise ValueError(f"input too short for filtfilt padlen {_PADLEN}")
    q = int(q)
    _, p64, _ = _cheby1_partial_fractions(q)
    flat = float(np.min(np.abs(1.0 - p64))) >= 0.1
    fwd = (lambda v: _plfilter_flat(v, q)) if flat else (
        lambda v: _plfilter_cascade(v, q))
    is_complex = x.is_complex()
    xc = x.to(torch.complex64)
    # odd-symmetric extension (scipy.signal._arraytools.odd_ext)
    left = 2.0 * xc[:1] - torch.flip(xc[1:_PADLEN + 1], [0])
    right = 2.0 * xc[-1:] - torch.flip(xc[n - _PADLEN - 1:n - 1], [0])
    y = fwd(torch.cat([left, xc, right]))
    y = torch.flip(fwd(torch.flip(y, [0])), [0])
    y = y[_PADLEN:_PADLEN + n][::q]
    return y if is_complex else y.real.float()
