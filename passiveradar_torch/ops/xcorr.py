"""FFT cross-correlation and channel time-offset estimation.

Port of the JAX package's ops/xcorr.py (reference signal_utils.py:29-32,
73-78). Lag convention of the reference's ``xcorr(s1, s2, nlead, nlag)``:

    out[j] = Σ_t s1[t]·conj(s2[t − (j − nlead)]),   j = 0 .. nlag+nlead
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.config import nextpow2
from passiveradar_torch.ops.fir import fir_decimate
from passiveradar_torch.ops.iir import iir_decimate
from passiveradar_torch.ops.mixer import frequency_shift
from passiveradar_torch.ops.util import deinterleave_iq, shift


def xcorr(s1: torch.Tensor, s2: torch.Tensor, nlead: int,
          nlag: int) -> torch.Tensor:
    """Cross-correlate s1 against delayed copies of s2 (see module doc)."""
    n = s1.shape[0]
    fft_len = nextpow2(n + max(nlag, nlead) + 1)
    full = torch.fft.ifft(torch.fft.fft(s1, fft_len)
                          * torch.fft.fft(s2, fft_len).conj())
    idx = torch.from_numpy(np.mod(np.arange(-nlead, nlag + 1), fft_len)).to(
        full.device)
    out = full[idx]
    if s1.is_complex() or s2.is_complex():
        return out
    return out.real.float()


def _offset_core(s1: torch.Tensor, s2: torch.Tensor, nd: int, nl: int,
                 antialias: str) -> int:
    """argmax over lags −nl..nl of |xcorr| after decimation by nd."""
    if antialias == "iir":
        b1, b2 = iir_decimate(s1, nd), iir_decimate(s2, nd)
    else:
        b1, b2 = fir_decimate(s1, nd), fir_decimate(s2, nd)
    m = b1.shape[0]
    nl = min(nl, m)
    return int(torch.argmax(xcorr(b1, b2, nl, nl).abs()))


def find_channel_offset(s1, s2, nd: int, nl: int, max_fft: int = 1 << 22,
                        antialias: str = "iir", device=None) -> int:
    """Constant sample offset between two channels (numpy or tensors).

    Reference semantics (signal_utils.py:73-78): decimate both channels by
    ``nd`` (scipy.signal.decimate's default cheby1 filtfilt, including the
    pure filtering pass at nd == 1; ``antialias="fir"`` selects the 20·q-tap
    FIR decimator), take |xcorr| over lags −nl..+nl and return
    (argmax − nl)·nd. Searches whose FFT would exceed ``max_fft`` points run
    as a coarse FIR-decimated pass refined by a narrow exact pass at the
    caller's nd and filter — same answer, bounded memory.
    """
    dev = resolve_device(device)
    s1 = torch.as_tensor(np.asarray(s1) if not torch.is_tensor(s1) else s1)
    s2 = torch.as_tensor(np.asarray(s2) if not torch.is_tensor(s2) else s2)
    nd = int(nd)
    n = int(s1.shape[0])
    needed = nextpow2(n // max(nd, 1) + int(nl) + 1)
    if needed > max_fft:
        extra = 1
        while nextpow2(n // (nd * extra) + int(nl) // extra + 1) > max_fft:
            extra *= 2
        coarse = find_channel_offset(s1, s2, nd * extra, int(nl) // extra,
                                     max_fft, antialias="fir", device=dev)
        r1, r2 = apply_offset(s1, s2, coarse)
        window = 4 * nd * extra
        keep = min(int(r1.shape[0]), max(8 * window, (max_fft // 2) * nd))
        fine = find_channel_offset(r1[:keep], r2[:keep], nd,
                                   max(window // nd, 1), max_fft,
                                   antialias=antialias, device=dev)
        return coarse + fine
    nl = int(min(nl, n // max(nd, 1)))
    b1 = s1.to(dev, torch.complex64)
    b2 = s2.to(dev, torch.complex64)
    return _offset_core(b1, b2, nd, nl, antialias) * nd - nl * nd


def apply_offset(ref, srv, offset: int):
    """Trim two channels into alignment given ``offset`` (reference
    main.py:67-72, 87-102): positive drops the first ``offset`` samples of
    ref and the last of srv, negative the converse."""
    if offset > 0:
        return ref[offset:], srv[:-offset]
    if offset < 0:
        return ref[:offset], srv[-offset:]
    return ref, srv


def offset_compensation(x1, x2, ns: int, ndec: int, nlag: int = 2000,
                        device=None) -> torch.Tensor:
    """Find and correct a constant time offset between two channels
    (reference signal_utils.py:49-71): the offset of the first ``ns``
    samples by ``find_channel_offset`` (decimation ``ndec``, lags ±nlag),
    then ``x2`` shifted by it with zero-filled edges. Numpy goes to
    ``device`` (the CUDA card by default)."""
    x2 = on_device(x2, device)
    os_ = find_channel_offset(x1[:int(ns)], x2[:int(ns)], ndec, nlag,
                              device=x2.device)
    return shift(x2, os_)


def channel_preprocessing(sig, dec: int, fc: float, fs: float,
                          device=None) -> torch.Tensor:
    """Deinterleave, tune by ``fc`` and FIR-decimate by ``dec`` (reference
    signal_utils.py:80-85). Numpy goes to ``device`` (the CUDA card by
    default)."""
    iq = deinterleave_iq(sig, device=device)
    return fir_decimate(frequency_shift(iq, fc, fs), dec)
