"""Cross-ambiguity function (CAF) → range-Doppler maps, batched over frames.

Port of the JAX package's ops/caf.py, ``short_filt=True`` path. The zero-phase
all-ones (d+1)-tap Doppler decimator of the reference
(range_doppler_processing.py:12-90) makes output row m the centred
(d+1)-window sum of the lag product around t = m·d:

    xambg[m, k] = Σ_{t=m·d−d/2}^{m·d+d/2} w[t]·ref[t]·conj(srv[t+R−k])

(zero for t < 0, circular in srv). Each window is a d-sample segment plus
one boundary sample, so the per-segment sums over all lags are a linear
cross-correlation of each (w·ref) segment against a (d+R)-sample srv
segment: three batched FFTs over all segments, then the Doppler FFT.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as _spsignal

from passiveradar_torch.config import nextpow2
from passiveradar_torch.ops.fft import fft_auto, ifft_auto


def resolve_window(window, n: int):
    """Window spec (None | str | tuple | array) → float32 numpy array or
    None; tensors pass through."""
    if window is None:
        return None
    if isinstance(window, (str, tuple)):
        return _spsignal.get_window(window, n).astype(np.float32)
    if isinstance(window, np.ndarray):
        return window.astype(np.float32)
    return window


def _caf_segment_tables(ref: torch.Tensor, srv: torch.Tensor, window,
                        range_bins: int, freq_bins: int):
    """Segment tables A (windowed-ref rows) and P (conj-srv rows), each
    (B, rows, d), for the segment-correlation CAF."""
    b, n = ref.shape
    nf = freq_bins
    r = range_bins
    d = n // nf
    half = d // 2
    n_extra = -(-r // d) + 1
    a = ref if window is None else ref * window
    rows = nf + n_extra + 1
    # a_pad[u] = a[u - half], zero outside
    a_pad = torch.nn.functional.pad(a, (half, rows * d - half - n))
    aa = a_pad.reshape(b, rows, d)
    # sext[u] = conj(srv[(u - half) mod n]), circular (np.roll semantics)
    total = rows * d
    sc = srv.conj()
    parts = [sc[:, n - half:]]
    remaining = total - half
    while remaining > n:
        parts.append(sc)
        remaining -= n
    parts.append(sc[:, :remaining])
    pp = torch.cat(parts, dim=-1).reshape(b, rows, d)
    return aa, pp, d, n_extra


def _caf_pre_rows(aa: torch.Tensor, pp: torch.Tensor, d: int, n_extra: int,
                  range_bins: int, row_count: int,
                  row0: int = 0) -> torch.Tensor:
    """pre[:, m, k] for segment rows m ∈ [row0, row0+row_count)."""
    r = range_bins
    nf = row_count
    a_rows = aa[:, row0:row0 + nf + 1]
    p_rows = pp[:, row0:row0 + nf + n_extra + 1]

    def windows_from(start_row: int, width: int):
        parts = [p_rows[:, start_row + i:start_row + i + nf]
                 for i in range(n_extra + 1)]
        return torch.cat(parts, dim=-1)[..., :width]

    # segment correlation: c[m, s] = Σ_i A[m, i] · S[m, i+s], s = 0..R
    s_win = windows_from(0, d + r)
    fft_len = nextpow2(d + r + 1)
    fs_ = fft_auto(s_win, fft_len)
    fa_ = fft_auto(a_rows[:, :nf].conj(), fft_len)
    c = ifft_auto(fs_ * fa_.conj())[..., :r + 1]
    # boundary sample of each centred window: a[(m+1)d − half]·sext[(m+1)d + s]
    term = a_rows[:, 1:nf + 1, 0:1] * windows_from(1, r + 1)
    pre = c + term                      # [m, shift], shift = R − k
    return torch.flip(pre, [-1])        # → [m, k], k = 0..R (lag −R..0)


def _doppler_transform(pre: torch.Tensor) -> torch.Tensor:
    """fftshift(fft(pre, Doppler axis), Doppler axis) for (..., nf, R+1)."""
    return torch.fft.fftshift(torch.fft.fft(pre, dim=-2), dim=-2)


def fast_xambg(ref: torch.Tensor, srv: torch.Tensor, range_bins: int,
               freq_bins: int, window=None,
               short_filt: bool = True) -> torch.Tensor:
    """Fast cross-ambiguity surfaces.

    ref/srv: (N,) or (B, N) complex64. Returns (freq_bins, range_bins+1) or
    (B, freq_bins, range_bins+1) complex64, matching the reference's
    ``fast_xambg`` to float32 round-off. Only the short_filt=True boxcar
    Doppler decimator (the pipeline default) is ported.
    """
    if not short_filt:
        raise NotImplementedError("only the short_filt=True CAF is ported")
    single = ref.dim() == 1
    if single:
        ref, srv = ref[None], srv[None]
    ref = ref.to(torch.complex64)
    srv = srv.to(torch.complex64)
    n = ref.shape[-1]
    if n % freq_bins:
        raise ValueError(f"input length {n} not divisible by freq_bins "
                         f"{freq_bins}")
    d = n // freq_bins
    if d % 2:
        raise ValueError("segment CAF path requires an even decimation factor")
    win = resolve_window(window, n)
    if isinstance(win, np.ndarray):
        win = torch.from_numpy(win).to(ref.device)
    aa, pp, d, n_extra = _caf_segment_tables(ref, srv, win, int(range_bins),
                                             int(freq_bins))
    pre = _caf_pre_rows(aa, pp, d, n_extra, int(range_bins), int(freq_bins))
    out = _doppler_transform(pre)
    return out[0] if single else out
