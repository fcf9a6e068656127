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

import functools

import numpy as np
import torch
from scipy import signal as _spsignal

from passiveradar_torch._device import on_device
from passiveradar_torch.config import nextpow2
from passiveradar_torch.ops.fft import fft_auto, ifft_auto
from passiveradar_torch.ops.fir import design_lowpass


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


@functools.cache
def _window_on(spec, n: int, device: torch.device) -> torch.Tensor:
    if isinstance(spec, bytes):
        win = np.frombuffer(spec, np.float32).copy()
    else:
        win = resolve_window(spec, n)
    return torch.from_numpy(win).to(device)


def device_window(window, n: int, device: torch.device):
    """``resolve_window(window, n)`` on ``device``: None, a tensor as it is,
    a spec or a numpy window made once per (window, n, device) and kept
    (unbounded: a replayed CUDA graph reads it by address, ops/graphs.py),
    so no call copies it from the host."""
    if window is None or torch.is_tensor(window):
        return window
    if isinstance(window, np.ndarray):
        window = np.ascontiguousarray(window, np.float32).tobytes()
    return _window_on(window, int(n), torch.device(device))


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


def _flattop_blocks(taps: np.ndarray, d: int):
    """The decimator's taps as C blocks of d for the block-polyphase CAF.

    decimate_taps computes out[g] = Σ_j h[j]·x[g·d + half − j], half =
    (L−1)//2. With hf the reversed taps, left pad pl = d·⌈(L−1−half)/d⌉ and
    e = pl − (L−1−half) leading zeros, out[g] = Σ_c Σ_r B[c, r]·xp[(g+c)·d
    + r], xp[u] = x[u − pl] and B[c, r] = hz[c·d + r]. Returns (B (C, d)
    float32, pl)."""
    length = len(taps)
    off = length - 1 - (length - 1) // 2
    pl = d * (-(-off // d))
    e = pl - off
    c = -(-(length + e) // d)
    hz = np.zeros(c * d, np.float64)
    hz[e:e + length] = np.asarray(taps, np.float64)[::-1]
    return hz.reshape(c, d).astype(np.float32), pl


@functools.cache
def _flattop_taps(d: int) -> np.ndarray:
    """The reference's flattop Doppler decimator for factor d (10·d+1
    taps), designed once."""
    return design_lowpass(10 * d + 1, 1.0 / d, "flattop")


@functools.cache
def _blocks_on(taps: bytes, d: int, device: torch.device) -> tuple:
    blocks, pl = _flattop_blocks(np.frombuffer(taps, np.float64), d)
    return torch.from_numpy(blocks).to(device), pl


def _fast_xambg_general(ref: torch.Tensor, srv: torch.Tensor, window,
                        taps: np.ndarray, range_bins: int,
                        freq_bins: int) -> torch.Tensor:
    """The CAF with a general Doppler decimator (reference shortFilt=False:
    the flattop taps), the JAX package's per-lag ``decimate_taps`` of the
    lag product, in block-polyphase form.

    Per lag k the decimated product is Σ_c Y_c[g + c] with Y_c[s] =
    Σ_r B[c, r]·a[s·d + r − pl]·conj(srv[s·d + r − pl + R − k]), a the
    windowed reference (zero outside the frame), srv circular: for each
    tap block c this is the boxcar path's segment correlation of the rows
    B[c]·a_s against (d+R)-sample srv windows, so all lags come from FFTs
    of length ≥ d+R+1, and the C blocks sum in the frequency domain. Memory
    is O(C·n) over the batch, not O(R·n).
    """
    b, n = ref.shape
    nf, r = freq_bins, range_bins
    d = n // nf
    # made once per (taps, d, device): no host copy per call
    bk, pl = _blocks_on(np.ascontiguousarray(taps, np.float64).tobytes(), d,
                        ref.device)
    nc = bk.shape[0]
    rows = nf + nc - 1
    a = ref if window is None else ref * window
    # ap[u] = a[u − pl], zero outside; d-rows s = 0..rows−1
    ap = torch.nn.functional.pad(a, (pl, max(0, rows * d - pl - n)))
    aa = ap[:, :rows * d].reshape(b, rows, d)
    # S_s[i] = conj(srv[(s·d − pl + i) mod n]), i < d + R: circular windows
    sc = srv.conj()
    reps = -(-(rows * d + r + pl) // n) + 1
    ext = sc.repeat(1, reps)[:, (-pl) % n:]
    s_win = ext.unfold(-1, d + r, d)[:, :rows]         # (B, rows, d + R)
    fft_len = nextpow2(d + r + 1)
    fs_ = fft_auto(s_win, fft_len)
    acc = None
    for c in range(nc):
        fa_ = fft_auto((aa[:, c:c + nf] * bk[c]).conj(), fft_len)
        term = fs_[:, c:c + nf] * fa_.conj()
        acc = term if acc is None else acc + term
    pre = ifft_auto(acc)[..., :r + 1]                 # [g, shift], R − k
    return _doppler_transform(torch.flip(pre, [-1]))


def fast_xambg(ref: torch.Tensor, srv: torch.Tensor, range_bins: int,
               freq_bins: int, window=None,
               short_filt: bool = True) -> torch.Tensor:
    """Fast cross-ambiguity surfaces.

    ref/srv: (N,) or (B, N) complex64. Returns (freq_bins, range_bins+1) or
    (B, freq_bins, range_bins+1) complex64, matching the reference's
    ``fast_xambg`` to float32 round-off. short_filt=True is the all-ones
    (d+1)-tap Doppler decimator (the pipeline default) on the segment
    correlation; short_filt=False the 10·d+1-tap flattop design
    (``_fast_xambg_general``).
    """
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
    win = device_window(window, n, ref.device)
    if short_filt:
        if d % 2:
            raise ValueError("segment CAF path requires an even decimation "
                             "factor")
        aa, pp, d, n_extra = _caf_segment_tables(ref, srv, win,
                                                 int(range_bins),
                                                 int(freq_bins))
        out = _doppler_transform(_caf_pre_rows(aa, pp, d, n_extra,
                                               int(range_bins),
                                               int(freq_bins)))
    else:
        out = _fast_xambg_general(ref, srv, win, _flattop_taps(d),
                                  int(range_bins),
                                  int(freq_bins))
    return out[0] if single else out


def fast_xambg_tp(ref, srv, range_bins: int, freq_bins: int, mesh,
                  window=None) -> list:
    """Tensor-parallel CAF: one frame spread over the shards of ``mesh``
    (parallel/mesh.FrameMesh), for frames too large or too latency-bound
    for one device.

    The segment-correlation stage is row-independent, so shard i computes
    segment rows [i·nf/n, (i+1)·nf/n) on its device; copies then gather
    each shard's block of (R+1)/n lags from every row block onto that
    shard (the JAX package's tiled all_to_all: each shard receives 1/n of
    the pre-FFT matrix, not all of it), and each shard runs the Doppler FFT
    over its lags. ref/srv: (N,) complex64, numpy or tensors. Returns the
    per-shard (freq_bins, (range_bins+1)/n) lag blocks in lag order, each
    on its shard's device; their concatenation along the lag axis equals
    fast_xambg's (boxcar decimator, short_filt=True).
    """
    n = len(mesh)
    if freq_bins % n or (range_bins + 1) % n:
        raise ValueError(f"freq_bins {freq_bins} and range_bins+1 "
                         f"{range_bins + 1} must divide the {n}-shard mesh")
    rows_per = freq_bins // n
    lags_per = (range_bins + 1) // n
    win = resolve_window(window, ref.shape[-1])
    pres = []
    for i, dev in enumerate(mesh.devices):
        r = on_device(ref, dev).to(torch.complex64)[None]
        s = on_device(srv, dev).to(torch.complex64)[None]
        aa, pp, d, n_extra = _caf_segment_tables(
            r, s, None if win is None else on_device(win, dev),
            int(range_bins), int(freq_bins))
        pres.append(_caf_pre_rows(aa, pp, d, n_extra, int(range_bins),
                                  rows_per, i * rows_per)[0])
    out = []
    for j, dev in enumerate(mesh.devices):
        lags = slice(j * lags_per, (j + 1) * lags_per)
        mine = torch.cat([p[:, lags].to(dev, non_blocking=True)
                          for p in pres], dim=0)     # (freq_bins, lags_per)
        out.append(_doppler_transform(mine))
    return out


def direct_xambg(ref, srv, range_bins: int, freq_bins: int,
                 sample_rate: float, device=None) -> torch.Tensor:
    """Direct (time-domain) CAF, the validation oracle of ``fast_xambg``
    (reference range_doppler_processing.py:93-124): row i is the
    0..range_bins-lag cross-correlation (``xcorr(·, ·, range_bins, 0)``) of
    the reference shifted by (i − nf/2)/CPI Hz against the surveillance
    channel. ref/srv (N,); numpy goes to ``device`` (the CUDA card by
    default). Returns (freq_bins, range_bins+1) complex64."""
    ref = on_device(ref, device).to(torch.complex64)
    srv = on_device(srv, device).to(device=ref.device, dtype=torch.complex64)
    n = ref.shape[-1]
    cpi = n / float(sample_rate)
    t = torch.arange(n, dtype=torch.float32, device=ref.device) / \
        np.float32(sample_rate)
    fft_len = nextpow2(n + range_bins + 1)
    f_srv = torch.fft.fft(srv, n=fft_len).conj()
    idx = torch.from_numpy(np.mod(np.arange(-range_bins, 1), fft_len)).to(
        ref.device)
    rows = []
    for i in range(freq_bins):
        df = np.float32((i - 0.5 * freq_bins) / cpi)
        theta = 2 * np.pi * df * t
        shifted = ref * torch.complex(torch.cos(theta), torch.sin(theta))
        full = torch.fft.ifft(torch.fft.fft(shifted, n=fft_len) * f_srv)
        rows.append(full[idx])
    return torch.stack(rows)
