"""The radar chain, stage by stage, in plain PyTorch.

Each function follows the upstream processor's definition of its stage:

* ``mix``: the down-conversion with phase-continuous per-frame starting
  phases (main.py:122-149, signal_utils.frequency_shift);
* ``resample``: ``scipy.signal.resample_poly(x, up, down,
  window=('kaiser', 5.0), padtype='line')`` on each frame (main.py:152-166),
  as a direct zero-stuffed FFT convolution;
* ``ls_multiple``: ``LS_Filter_Multiple`` (clutter_removal.py:109-187): per
  Doppler bin the reference frequency-shifted, rolled back by ``peek``, the
  linear correlation lags, a dense Toeplitz solve and the clutter
  convolution subtracted, bin after bin;
* ``halo``: ``da.overlap.overlap(depth=cpi/4, boundary=0)`` (main.py:178-181);
* ``caf``: ``fast_xambg`` with the window (main.py:183-194): per lag the
  lag product, the zero-phase boxcar decimator of d + 1 ones as a centred
  window sum, the Doppler FFT and its shift;
* ``channelize``: the critically sampled polyphase filter bank of the
  wideband mode, and ``integrate`` the sum of |CAF| over channels.

Rows are frames. ``prec`` is ``precision.FP64`` (the reference) or
``precision.TF32`` (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import FP64, Precision


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def firwin(numtaps: int, cutoff: float, beta: float) -> np.ndarray:
    """Windowed-sinc lowpass (``scipy.signal.firwin`` with a Kaiser window
    of ``beta``; cutoff relative to Nyquist), unit gain at DC, float64."""
    m = np.arange(numtaps, dtype=np.float64) - 0.5 * (numtaps - 1)
    h = cutoff * np.sinc(cutoff * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def kaiser_periodic(n: int, beta: float) -> np.ndarray:
    """``scipy.signal.get_window(('kaiser', beta), n)`` (periodic)."""
    return np.kaiser(n + 1, beta)[:-1]


def block_phases(frames, block_len: int, fc: float, fs: float) -> np.ndarray:
    """The starting phase of each frame (main.py:125-130): 2π·k·((block_len
    mod (fs // fc))·fc/fs), float64 radians."""
    k = np.asarray(frames, dtype=np.float64)
    if fc == 0:
        return np.zeros_like(k)
    osb = block_len % (int(fs) // int(fc))
    return 2.0 * np.pi * np.mod(k * (osb * float(fc) / float(fs)), 1.0)


def mix(x: torch.Tensor, fc: float, fs: float, phases,
        prec: Precision = FP64) -> torch.Tensor:
    """x (F, n) · e^{j(2π·fc·t/fs + phase_f)}; the oscillator from float64
    cycles."""
    n = x.shape[-1]
    cyc = torch.remainder(torch.arange(n, dtype=torch.float64,
                                       device=x.device) * (fc / fs), 1.0)
    ph = torch.as_tensor(np.asarray(phases, np.float64), device=x.device)
    arg = 2 * math.pi * cyc[None, :] + ph[:, None]
    osc = prec.q(torch.polar(torch.ones_like(arg), arg))
    return prec.q(prec.q(x) * osc)


def _resample_taps(up: int, down: int) -> tuple:
    """resample_poly's filter and alignment (scipy.signal.resample_poly)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, 5.0) * up
    n_pre_pad = down - half_len % down
    return h, half_len, n_pre_pad


def resample(x: torch.Tensor, up: int, down: int,
             prec: Precision = FP64) -> torch.Tensor:
    """resample_poly(x, up, down, window=('kaiser', 5.0), padtype='line')
    along the last axis of (F, n) rows: the input extended by its
    end-to-end linear trend, zero-stuffed by ``up``, convolved with the
    taps by FFT, and every ``down``-th sample kept."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    f, n = x.shape
    h, half_len, n_pre_pad = _resample_taps(up, down)
    n_out = n * up // down + bool((n * up) % down)
    n_pre_remove = (half_len + n_pre_pad) // down
    len_h = len(h) + n_pre_pad
    while ((n - 1) * up + len_h - 1) // down + 1 < n_out + n_pre_remove:
        len_h += 1
    hp = np.zeros(len_h)
    hp[n_pre_pad:n_pre_pad + len(h)] = h
    # 'line' extension: ext samples of the linear trend on each side
    ext = -(-len_h // up) + 1
    x = prec.q(x)
    slope = (x[:, -1:] - x[:, :1]) / max(n - 1, 1)
    k = torch.arange(1, ext + 1, dtype=prec.real, device=x.device)
    xe = torch.cat([x[:, :1] - slope * k.flip(0), x,
                    x[:, -1:] + slope * k], dim=1)
    ne = xe.shape[1]
    length = _pow2(ne * up + len_h)
    xu = torch.zeros((f, length), dtype=prec.complex, device=x.device)
    xu[:, :ne * up:up] = xe
    fh = torch.fft.fft(prec.q(torch.from_numpy(hp).to(x.device)), n=length)
    z = torch.fft.ifft(torch.fft.fft(xu, dim=-1) * fh, dim=-1)
    # output sample j of the unextended upfirdn sits at z[j·down + ext·up]
    idx = (torch.arange(n_pre_remove, n_pre_remove + n_out,
                        device=x.device) * down + ext * up)
    return prec.q(z[:, idx])


def fit_length(x: torch.Tensor, n: int) -> torch.Tensor:
    """Trim or zero-pad rows to ``n`` (the per-chunk resample may be one
    sample off the frame's output length)."""
    if x.shape[-1] >= n:
        return x[..., :n]
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _linear_corr(a: torch.Tensor, b: torch.Tensor, lags: int) -> torch.Tensor:
    """c[k] = Σ_t a[t + k]·conj(b[t]), k = 0 … lags − 1 (zero outside)."""
    n = a.shape[-1]
    length = _pow2(2 * n)
    full = torch.fft.ifft(torch.fft.fft(a, n=length)
                          * torch.fft.fft(b, n=length).conj())
    return full[..., :lags]


def ls_toeplitz(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
                prec: Precision = FP64, peek: int = 10) -> torch.Tensor:
    """LS_Filter_Toeplitz (clutter_removal.py:109-160) on (F, n) rows."""
    n = ref.shape[-1]
    m = filter_len + peek
    rs = prec.q(torch.roll(ref, -peek, dims=-1))
    ac = prec.q(_linear_corr(rs, rs, m))
    cc = prec.q(_linear_corr(srv, rs, m))
    i = torch.arange(m, device=ref.device)
    d = i[:, None] - i[None, :]
    # Hermitian Toeplitz with first column ac (scipy.linalg.solve_toeplitz)
    t = torch.where(d >= 0, ac[:, d.clamp(min=0)],
                    ac[:, (-d).clamp(min=0)].conj())
    taps = prec.q(torch.linalg.solve(t, cc[..., None])[..., 0])
    length = _pow2(n + m)
    clutter = torch.fft.ifft(torch.fft.fft(rs, n=length)
                             * torch.fft.fft(taps, n=length))[..., :n]
    return prec.q(srv - prec.q(clutter))


def ls_multiple(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
                fs: float, bins, prec: Precision = FP64) -> torch.Tensor:
    """LS_Filter_Multiple (clutter_removal.py:162-187): one LS pass a
    Doppler bin in order, a nonzero bin's reference shifted by it first."""
    ref, srv = prec.q(ref), prec.q(srv)
    out = srv
    for b in bins:
        rm = ref if b == 0 else mix(ref, b, fs, np.zeros(ref.shape[0]), prec)
        out = ls_toeplitz(rm, out, filter_len, prec)
    return out


def halo(x: torch.Tensor, depth: int, left=None, right=None) -> torch.Tensor:
    """(F, n) → (F, n + 2·depth): each row with the previous row's tail and
    the next row's head; ``left`` / ``right`` (n,) are the neighbours of
    the first and last rows (zero when None: the capture's edges)."""
    z = torch.zeros((1, depth), dtype=x.dtype, device=x.device)
    lt = z if left is None else left[None, -depth:].to(x.dtype)
    rt = z if right is None else right[None, :depth].to(x.dtype)
    lefts = torch.cat([lt, x[:-1, -depth:]], dim=0)
    rights = torch.cat([x[1:, :depth], rt], dim=0)
    return torch.cat([lefts, x, rights], dim=1)


def caf(ref: torch.Tensor, srv: torch.Tensor, range_bins: int,
        freq_bins: int, window: np.ndarray,
        prec: Precision = FP64, lag_block: int = 16) -> torch.Tensor:
    """fast_xambg with a window, boxcar decimator (shortFilt): (F, n) rows
    → (F, freq_bins, range_bins + 1).

    X[m, k] = Σ_{t = m·d − d/2}^{m·d + d/2} w[t]·ref[t]·conj(srv[(t + R − k)
    mod n]) (t outside the frame contributes 0), then the FFT over m and
    its shift."""
    f, n = ref.shape
    d = n // freq_bins
    half = d // 2
    a = prec.q(prec.q(ref) * prec.q(torch.from_numpy(
        np.asarray(window, np.float64)).to(ref.device)))
    sc = prec.q(srv).conj()
    m = torch.arange(freq_bins, device=ref.device) * d
    hi = torch.clamp(m + half + 1, max=n)
    lo = torch.clamp(m - half, min=0)
    pre = torch.empty((f, freq_bins, range_bins + 1), dtype=prec.complex,
                      device=ref.device)
    for s0 in range(0, range_bins + 1, lag_block):
        shifts = range(s0, min(s0 + lag_block, range_bins + 1))
        prod = torch.stack([a * torch.roll(sc, -s, dims=-1) for s in shifts],
                           dim=1)                       # (F, S, n)
        c = torch.nn.functional.pad(torch.cumsum(prod, dim=-1), (1, 0))
        sums = c[..., hi] - c[..., lo]                  # (F, S, nf)
        for j, s in enumerate(shifts):
            pre[:, :, range_bins - s] = sums[:, j]
    pre = prec.q(pre)
    return prec.q(torch.fft.fftshift(torch.fft.fft(pre, dim=1), dim=1))


def channelize(x: torch.Tensor, k: int, taps_per_branch: int,
               prec: Precision = FP64) -> torch.Tensor:
    """The critically sampled K-channel polyphase filter bank: (F, N) →
    (F, N // K, K), y[m, c] = Σ_p e^{−j2πcp/K} Σ_t h[tK + p]·x[(m − t)K + p]
    (x zero before the start), h the Kaiser-9 lowpass of K·T taps with
    cutoff 1/K."""
    f, n = x.shape
    mo = n // k
    h = prec.q(torch.from_numpy(
        firwin(k * taps_per_branch, 1.0 / k, 9.0).reshape(taps_per_branch,
                                                           k)).to(x.device))
    xb = prec.q(x[:, :mo * k]).reshape(f, mo, k)
    yb = torch.zeros_like(xb)
    for t in range(min(taps_per_branch, mo)):
        yb[:, t:] += xb[:, :mo - t] * h[t]
    return prec.q(torch.fft.fft(prec.q(yb), dim=-1))


def integrate(maps: torch.Tensor) -> torch.Tensor:
    """Noncoherent integration over the channel axis (dim 1): Σ |CAF|."""
    return maps.abs().sum(dim=1)
