"""Clutter cancellation: block least squares, NLMS and GAL-JPE.

Port of the JAX package's ops/clutter.py (reference clutter_removal.py):

* ``ls_filter_multiple`` (reference :162-187, bins (0, 1, -1, 2, -2) Hz,
  main.py:174) in its three formulations: 'carry' (the residual carried in
  the frequency domain, bin after bin), 'coupled' (every correlation up
  front, then only m-sized matvecs and solves bin after bin) and 'segment'
  (overlap-save segment Grams: exact for fractional bins); each with the
  Toeplitz solvers 'levinson' (Levinson-Durbin + Gohberg-Semencul
  generators), 'gs_matrix' and 'gs_dense' (the same inverse as a dense
  matrix) and 'cholesky' (a dense factorisation of each system).
* The single-bin block cancellers ``ls_filter_toeplitz`` (reference
  :109-160), ``ls_filter`` (:6-56) and ``ls_filter_svd`` (:58-107), and
  ``toeplitz_solve``.
* The adaptive cancellers ``nlms_filter`` (:189-249, on the CUDA kernel of
  ops/nlms_kernel.py) and ``gal_jpe`` (:251-364, a per-sample loop).

The LS functions take (n,) or a leading batch of frames (B, n): the JAX
package's vmap over frames becomes the leading axis, its ``lax.scan`` over
Doppler bins a Python loop. Correlations are circular FFT correlations
with exact triangular alias corrections (the *_wrap helpers). The small
dense solves use ``torch.linalg`` on the complex systems directly (the JAX
package's real 2m embedding is a TPU linalg workaround), except the
pseudo-inverse of ``ls_filter_svd``, whose cutoff is defined on that
embedding.

The constant tables of ``ls_filter_multiple`` (phase tables, the bin
frequencies, the roll ramp, the Toeplitz gather indices, the bin-pair
indices) are made once per (device, shape, parameter) and kept, so the
stage copies nothing from the host and can be captured as a CUDA graph
(``ls_filter_multiple_graphed``). Those caches are unbounded: a replayed
graph reads the tables by address, so they must outlive it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from passiveradar_torch._device import on_device
from passiveradar_torch.config import nextpow2
from passiveradar_torch.ops import graphs, levinson_kernel
from passiveradar_torch.ops.fft import fft_auto, ifft_auto
from passiveradar_torch.ops.mixer import frequency_shift
from passiveradar_torch.ops.nlms_kernel import nlms_filter_batch
from passiveradar_torch.ops.zoomfft import partial_ifft, sparse_fft

IMPLS = ("carry", "coupled", "segment")
SOLVERS = ("levinson", "gs_matrix", "gs_dense", "cholesky")
# the segment impl's FFT length, the JAX package's default (capped at the
# problem size): the geometry, and so the rounding, match it
SEGMENT_FFT_LEN = 4096


def _mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., a, b) @ (..., b) → (..., a)."""
    return torch.matmul(mat, v.unsqueeze(-1)).squeeze(-1)


# --------------------------------------------------------------------------
# correlation lags and small dense solves
# --------------------------------------------------------------------------

def linear_corr_lags(s1: torch.Tensor, s2: torch.Tensor,
                     nlags: int) -> torch.Tensor:
    """out[..., j] = Σ_t s1[t]·conj(s2[t−j]), j = 0..nlags−1 (zero-padded)."""
    fft_len = nextpow2(s1.shape[-1] + nlags)
    f1 = torch.fft.fft(s1, n=fft_len, dim=-1)
    f2 = torch.fft.fft(s2, n=fft_len, dim=-1)
    return torch.fft.ifft(f1 * f2.conj(), dim=-1)[..., :nlags]


def circular_corr_lags(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """out[..., l] = Σ_t s1[t+l]·conj(s2[t]), circular, full length."""
    return torch.fft.ifft(torch.fft.fft(s1, dim=-1)
                          * torch.fft.fft(s2, dim=-1).conj(), dim=-1)


def _solve_complex(a: torch.Tensor, b: torch.Tensor,
                   assume_pd: bool = False) -> torch.Tensor:
    """Solve A x = b for Hermitian A (..., m, m), b (..., m): Cholesky with
    ``assume_pd`` (no info check, so no host sync: a factorisation that
    fails gives non-finite taps, as the JAX package's does), else LU."""
    if assume_pd:
        chol = torch.linalg.cholesky_ex(a)[0]
        return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
    return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)


@functools.cache
def _toeplitz_index(m: int, device: torch.device):
    """(|i − j| gather indices, i ≥ j mask), each (m, m), on ``device``."""
    d = np.arange(m)[:, None] - np.arange(m)[None, :]
    return (torch.from_numpy(np.abs(d)).to(device),
            torch.from_numpy(d >= 0).to(device))


def _toeplitz_matrix(c: torch.Tensor) -> torch.Tensor:
    """Dense Hermitian Toeplitz matrices (..., m, m) with first columns c."""
    idx, lower = _toeplitz_index(c.shape[-1], c.device)
    cg = c[..., idx]
    return torch.where(lower, cg, cg.conj())


def _toeplitz_inverse_c(c: torch.Tensor) -> torch.Tensor:
    """Inverse of each Hermitian Toeplitz matrix (first columns c (..., m))
    by Cholesky and two triangular solves against the identity."""
    t = _toeplitz_matrix(c)
    chol = torch.linalg.cholesky_ex(t)[0]
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    y = torch.linalg.solve_triangular(chol, eye.expand_as(t), upper=False)
    return torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), y,
                                         upper=True)


def toeplitz_solve(c, b, assume_pd: bool = True, device=None) -> torch.Tensor:
    """Solve T x = b, T Hermitian Toeplitz with first column ``c`` (the row
    is conj(c), scipy.linalg.solve_toeplitz's default): a dense Cholesky
    solve (``assume_pd``, autocorrelation systems) or LU. c, b: (..., m);
    numpy inputs go to ``device`` (the CUDA card by default)."""
    c = on_device(c, device).to(torch.complex64)
    b = on_device(b, device).to(device=c.device, dtype=torch.complex64)
    return _solve_complex(_toeplitz_matrix(c), b, assume_pd=assume_pd)


def levinson_first_col(c: torch.Tensor) -> torch.Tensor:
    """First column x = T⁻¹e₀ of each Hermitian Toeplitz T, batched.

    ``c`` (..., m) is the first column of each T. Levinson-Durbin over the
    order (reference analog: scipy.solve_toeplitz,
    clutter_removal.py:109-160): on a CUDA tensor one launch of the kernel
    of ops/levinson_kernel.py for the whole batch, on a CPU tensor its
    plain loop of m−1 dependent steps.
    """
    if c.device.type != "cuda":
        return levinson_kernel.levinson_first_col_plain(c)
    m = c.shape[-1]
    x = levinson_kernel.levinson_first_col_kernel(
        c.reshape(-1, m).contiguous())
    return x.reshape(c.shape)


def gs_generators(x: torch.Tensor, fft_len: int):
    """Frequency-domain Gohberg-Semencul generators from x = T⁻¹e₀:
    T⁻¹ = (A·Aᴴ − B·Bᴴ)/δ, A = lower-Toeplitz(x), B = lower-Toeplitz(
    [0, conj(x[m-1]), …, conj(x[1])]), δ = x[0]. Returns (fft of A's column,
    fft of B's column, δ); fft_len must be ≥ 2m−1."""
    m = x.shape[-1]
    if fft_len < 2 * m - 1:
        raise ValueError("fft_len must be >= 2m-1")
    y = torch.nn.functional.pad(torch.flip(x[..., 1:], [-1]).conj(), (1, 0))
    return fft_auto(x, fft_len), fft_auto(y, fft_len), x[..., 0].real


def gs_apply(fx: torch.Tensor, fy: torch.Tensor, delta: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """y = T⁻¹ v from the Gohberg-Semencul generators (padded FFT convs);
    the A and B paths run stacked."""
    m = v.shape[-1]
    fft_len = fx.shape[-1]
    fg = torch.stack([fx, fy])                           # (2, ..., fft_len)
    fv = fft_auto(v, fft_len)
    hv = ifft_auto(fg.conj() * fv[None])[..., :m]
    prod = ifft_auto(fg * fft_auto(hv, fft_len))[..., :m]
    return (prod[0] - prod[1]) / delta[..., None]


def gs_dense_inverse(x: torch.Tensor) -> torch.Tensor:
    """Dense T⁻¹ = (A·Aᴴ − B·Bᴴ)/δ from the Levinson first column x
    (..., m): the Gohberg-Semencul generators of ``gs_generators`` as
    lower-triangular Toeplitz matrices, multiplied out in full f32 (the JAX
    package's 3-multiply bf16x3 product is a TPU precision trade).

    The generators are first divided by δ = x[0] and the product scaled by
    δ after, the same matrix: an all-zero frame's guarded system has
    δ = 1e25, whose unscaled square overflows float32 (the JAX package's
    product does, and its maps go NaN there).
    """
    m = x.shape[-1]
    lead = x.shape[:-1]
    zeros = torch.zeros(lead + (m + 1,), dtype=x.dtype, device=x.device)

    def lower_toeplitz(v):
        # L[j, t] = v[j−t] for j ≥ t: diagonal d = t−j ≤ 0 holds v[−d]
        return _skew_toeplitz(torch.cat(
            [v[..., :1], zeros, torch.flip(v[..., 1:], [-1])], dim=-1), m)

    delta = x[..., 0:1].real
    xh = x / delta
    a = lower_toeplitz(xh)
    y = torch.nn.functional.pad(torch.flip(xh[..., 1:], [-1]).conj(), (1, 0))
    b = lower_toeplitz(y)
    inv = a @ a.conj().transpose(-1, -2) - b @ b.conj().transpose(-1, -2)
    return inv * delta[..., None]


def _skew_toeplitz(e: torch.Tensor, m: int) -> torch.Tensor:
    """H[..., j, t] = e[..., (t−j) mod (2m+1)] from the (..., 2m+1)
    diagonal table, built by tiling and a row-stride-2m reshape."""
    lead = e.shape[:-1]
    tiled = e.unsqueeze(-2).expand(lead + (m, 2 * m + 1))
    flat = tiled.reshape(lead + (m * (2 * m + 1),))
    return flat[..., :2 * m * m].reshape(lead + (m, 2 * m))[..., :m]


def _tail_toeplitz(tails: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m−1, m) truncation-tail operators T[r, j] = rs[n+r−j] (j > r)
    from the last-m-samples rows tails[..., i] = rs[n−m+i]: diagonal
    d = j−r ∈ [1, m−1] holds tails[m−d]."""
    lead = tails.shape[:-1]
    z1 = torch.zeros(lead + (1,), dtype=tails.dtype, device=tails.device)
    zr = torch.zeros(lead + (m + 1,), dtype=tails.dtype, device=tails.device)
    e = torch.cat([z1, torch.flip(tails[..., 1:], [-1]), zr], dim=-1)
    return _skew_toeplitz(e, m)[..., :m - 1, :]


def _two_sided_toeplitz(v: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m, m) Toeplitz M[l, j] = v[(l−j) + m − 1] from the (..., 2m−1)
    two-sided lag vector: diagonal d = j−l holds v[m−1−d]."""
    z2 = torch.zeros(v.shape[:-1] + (2,), dtype=v.dtype, device=v.device)
    e = torch.cat([torch.flip(v[..., :m], [-1]), z2,
                   torch.flip(v[..., m:], [-1])], dim=-1)
    return _skew_toeplitz(e, m)


def _tri_corr_wrap(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """Circular-correlation alias terms w[j] = Σ_{t<j} a[t]·conj(b[t+m−j])
    (a = head of s1, b = tail of s2, both (..., m))."""
    z = torch.zeros(b.shape[:-1] + (m + 2,), dtype=b.dtype, device=b.device)
    e = torch.cat([z, b[..., 1:].conj()], dim=-1)
    return _mv(_skew_toeplitz(e, m), a)


def _tri_conv_wrap(taps: torch.Tensor, tail: torch.Tensor,
                   m: int) -> torch.Tensor:
    """Circular-convolution alias terms w[t] = Σ_{j>t} taps[j]·tail[m+t−j]."""
    lead = tail.shape[:-1]
    z1 = torch.zeros(lead + (1,), dtype=tail.dtype, device=tail.device)
    zr = torch.zeros(lead + (m + 1,), dtype=tail.dtype, device=tail.device)
    e = torch.cat([z1, torch.flip(tail[..., 1:], [-1]), zr], dim=-1)
    return _mv(_skew_toeplitz(e, m), taps)


def _toeplitz_ls_pass(rs: torch.Tensor, srv: torch.Tensor, m: int):
    """One LS pass against the (peek-advanced) reference ``rs``: linear
    correlations from length-n circular FFTs minus their alias terms, a
    dense Toeplitz solve, and the truncated clutter convolution. Returns
    (srv − clutter, taps)."""
    n = srv.shape[-1]
    f_rs = torch.fft.fft(rs, dim=-1)
    f_srv = torch.fft.fft(srv, dim=-1)
    rs_tail = rs[..., n - m:]
    ac = torch.fft.ifft(f_rs * f_rs.conj(), dim=-1)[..., :m] \
        - _tri_corr_wrap(rs[..., :m], rs_tail, m)
    cc = torch.fft.ifft(f_srv * f_rs.conj(), dim=-1)[..., :m] \
        - _tri_corr_wrap(srv[..., :m], rs_tail, m)
    taps = _solve_complex(_toeplitz_matrix(ac), cc, assume_pd=True)
    clutter = torch.fft.ifft(f_rs * torch.fft.fft(taps, n=n, dim=-1), dim=-1)
    clutter[..., :m] -= _tri_conv_wrap(taps, rs_tail, m)
    return srv - clutter, taps


def _as_pair(ref, srv, device):
    ref = on_device(ref, device).to(torch.complex64)
    srv = on_device(srv, device).to(device=ref.device, dtype=torch.complex64)
    return ref, srv


def ls_filter_toeplitz(ref, srv, filter_len: int, peek: int = 10,
                       return_filter: bool = False, device=None):
    """WSS block LS clutter canceller (reference clutter_removal.py:109-160):
    the Toeplitz normal equations of the linear correlation lags of the
    peek-advanced reference, and the clutter (the taps' full convolution
    with it, truncated) subtracted. ref/srv: (n,) or (B, n); numpy inputs
    go to ``device`` (the CUDA card by default). Returns the cleaned srv,
    and the (…, filter_len + peek) taps with ``return_filter``."""
    ref, srv = _as_pair(ref, srv, device)
    out, taps = _toeplitz_ls_pass(torch.roll(ref, -peek, dims=-1), srv,
                                  filter_len + peek)
    return (out, taps) if return_filter else out


def _phase_tab(mus, tau: np.ndarray, n: int) -> np.ndarray:
    """e^{j2π·μ_b·τ/n} (nb, len(τ)) complex64 from float64 cycles."""
    cyc = np.mod(np.outer(np.asarray(mus), tau / n), 1.0)
    return np.exp(2j * np.pi * cyc).astype(np.complex64)


@functools.cache
def _edge_phases(mus: tuple, n: int, m: int, peek: int,
                 device: torch.device):
    """The phase tables of the per-bin heads (samples peek … peek+m−1) and
    tails (n−m+peek … n+peek−1, wrapped) on ``device``."""
    tau_h = np.arange(peek, peek + m, dtype=np.float64)
    tau_t = np.arange(n - m + peek, n + peek, dtype=np.float64)
    tau_t = np.where(tau_t < n, tau_t, tau_t - n)
    return (torch.from_numpy(_phase_tab(mus, tau_h, n)).to(device),
            torch.from_numpy(_phase_tab(mus, tau_t, n)).to(device))


@functools.cache
def _bin_freqs(bins: tuple, device: torch.device) -> torch.Tensor:
    """The Doppler bins (nb,) float32 on ``device``."""
    return torch.tensor(np.asarray(bins, np.float32), device=device)


@functools.cache
def _roll_ramp(n: int, peek: int, device: torch.device) -> torch.Tensor:
    """e^{j2π·peek·k/n} (n,) complex64 on ``device``: the spectrum of a
    time roll by −peek."""
    return torch.from_numpy(np.exp(
        2j * np.pi * np.mod(np.arange(n, dtype=np.float64) * peek / n, 1.0)
    ).astype(np.complex64)).to(device)


def _modulated_ref_spectra(ref: torch.Tensor, n: int, m: int, peek: int,
                           sample_rate: float, doppler_bins,
                           extra: torch.Tensor | None = None):
    """Spectra, heads and tails of the per-bin modulated references.

    ref: (B, n). Returns (f_rs_all (B, nb, n), heads (B, nb, m),
    tails (B, nb, m)[, f_extra]): the FFT of roll(ref·e^{j2πf_b t}, −peek)
    for every bin, plus its first/last m samples (exact float64 phase
    tables). For near-integer bin shifts k (|δ| = |f_b·T − k| ≤ 5e-3) the
    spectra are integer rolls of 2-3 base FFTs (ref, t·ref[, t²·ref]) with a
    first- or second-order Taylor ramp; farther from integer, direct per-bin
    FFTs. ``extra`` (B, k, n) rows ride the same batched transform.
    """
    bins = [float(f) for f in doppler_bins]
    nb = len(bins)
    dev = ref.device
    T = n / float(sample_rate)
    mus = [f * T for f in bins]
    ks = [int(round(mu)) for mu in mus]
    deltas = [mu - k for mu, k in zip(mus, ks)]
    dmax = max(abs(d) for d in deltas)
    order = 1 if dmax <= 5e-4 else (2 if dmax <= 5e-3 else 0)

    head_base = ref[:, peek:peek + m]
    tail_base = torch.cat([ref[:, n - m + peek:], ref[:, :peek]], dim=-1)
    head_tab, tail_tab = _edge_phases(tuple(mus), n, m, peek, dev)
    heads = head_base[:, None, :] * head_tab[None]
    tails = tail_base[:, None, :] * tail_tab[None]

    if order == 0:
        t32 = torch.arange(n, dtype=torch.float32, device=dev) / float(
            np.float32(sample_rate))
        fb = _bin_freqs(tuple(bins), dev)
        theta = 2.0 * np.pi * fb[:, None] * t32[None, :]
        rs_all = torch.roll(
            ref[:, None, :] * torch.complex(torch.cos(theta),
                                            torch.sin(theta))[None],
            -peek, dims=-1)
        if extra is not None:
            stacked = fft_auto(torch.cat([rs_all, extra], dim=1))
            return stacked[:, :nb], heads, tails, stacked[:, nb:]
        return fft_auto(rs_all), heads, tails

    w = 2.0 * np.pi / n
    tdev = torch.arange(n, dtype=torch.float32, device=dev)
    rows = [ref, ref * tdev]
    if order == 2:
        rows.append(ref * (tdev * tdev))
    nbase = len(rows)
    stacked = torch.stack(rows, dim=1)
    if extra is not None:
        stacked = torch.cat([stacked, extra], dim=1)
    fbase = fft_auto(stacked)
    f_extra = None if extra is None else fbase[:, nbase:]
    f0, f1 = fbase[:, 0], fbase[:, 1]
    f2 = fbase[:, 2] if order == 2 else None
    ramp = _roll_ramp(n, peek, dev)                      # time roll by -peek
    ys = []
    for k, d in zip(ks, deltas):
        # float32-rounded coefficients, as the JAX package forms them
        s = complex(0.0, float(np.float32(w * d)))
        y = torch.roll(f0, k, dims=-1) + s * torch.roll(f1, k, dims=-1)
        if order == 2:
            s2 = float(np.float32(0.5 * (w * d) ** 2))
            y = y - s2 * torch.roll(f2, k, dims=-1)
        ys.append(y)
    f_rs_all = ramp * torch.stack(ys, dim=1)
    if extra is not None:
        return f_rs_all, heads, tails, f_extra
    return f_rs_all, heads, tails


def _solver_data(ac_all: torch.Tensor, m: int, solver: str):
    """Per-bin solve machinery from the (B, nb, m) autocorrelations.

    Returns (xs, apply_inv): xs a tuple of (B, nb, …) tensors, and
    apply_inv(sd, cc) solving T_b x = cc for sd = tuple(x[:, b] for x in xs)
    and cc (B, m).
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown toeplitz solver {solver!r}")
    if solver == "cholesky":
        return (_toeplitz_inverse_c(ac_all),), lambda sd, cc: _mv(sd[0], cc)
    x_all = levinson_first_col(ac_all)
    if solver == "gs_dense":
        return (gs_dense_inverse(x_all),), lambda sd, cc: _mv(sd[0], cc)
    if solver == "levinson":
        return (gs_generators(x_all, nextpow2(2 * m)),
                lambda sd, cc: gs_apply(*sd, cc))
    # gs_matrix: the G-S generators applied to the identity in one batched
    # transform round; row i of w_b is T_b⁻¹eᵢ, so T_b⁻¹cc = wᵀcc. As in
    # gs_dense_inverse, the generators of x/δ (δ' = 1) and w scaled by δ
    # after, so that an all-zero frame's w stays finite
    eye = torch.eye(m, dtype=torch.complex64, device=ac_all.device)
    delta_all = x_all[..., 0].real
    fxh, fyh, _ = gs_generators(x_all / delta_all[..., None], nextpow2(2 * m))
    w_all = gs_apply(fxh[..., None, :], fyh[..., None, :],
                     torch.ones_like(delta_all)[..., None], eye)
    return ((w_all * delta_all[..., None, None],),
            lambda sd, cc: _mv(sd[0].transpose(-1, -2), cc))


def _guard(ac_all: torch.Tensor) -> torch.Tensor:
    """Vanishing-diagonal guard: rounded away for real captures, keeps the
    solves finite for all-zero frames (the pipeline's margin frames)."""
    ac_all = ac_all.clone()
    ac_all[..., 0] += 1e-25 * torch.clamp(ac_all[..., 0].abs(), min=1.0)
    return ac_all


def _coupled_taps(cc0, m_pair, pairs, solve_xs, apply_inv):
    """The serial chain of the coupled and segment impls: per bin b,
    taps_b = T_b⁻¹(cc0_b − Σ_{a<b} M_ab·taps_a). cc0 (B, nb, m),
    m_pair (B, len(pairs), m, m) → taps (B, nb, m)."""
    pair_of = {ab: i for i, ab in enumerate(pairs)}
    taps = []
    for b in range(cc0.shape[1]):
        cc = cc0[:, b]
        for a in range(b):
            cc = cc - _mv(m_pair[:, pair_of[(a, b)]], taps[a])
        taps.append(apply_inv(tuple(x[:, b] for x in solve_xs), cc))
    return torch.stack(taps, dim=1)


def ls_filter_multiple(ref, srv, filter_len: int, sample_rate: float,
                       doppler_bins=(0,), solver: str = "levinson",
                       impl: str = "carry", device=None) -> torch.Tensor:
    """Sequential per-Doppler-bin LS passes (reference
    clutter_removal.py:162-187): nonzero bins frequency-shift the reference
    before its pass.

    ref/srv: (n,) or (B, n) complex64; numpy inputs go to ``device`` (the
    CUDA card by default). ``impl`` 'carry' (the pipeline's default: the
    residual carried in the frequency domain, per-bin spectra from integer
    rolls of 2-3 base FFTs with a Taylor ramp for the fractional part),
    'coupled' (the same correlations all up front, the bin chain reduced to
    m-sized matvecs and solves) or 'segment' (overlap-save segment Grams,
    exact for fractional bins). ``solver``: one of SOLVERS.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown ls_filter_multiple impl {impl!r}")
    if solver not in SOLVERS:
        raise ValueError(f"unknown toeplitz solver {solver!r}")
    ref, srv = _as_pair(ref, srv, device)
    single = ref.dim() == 1
    if single:
        ref, srv = ref[None], srv[None]
    run = dict(carry=_ls_multiple_carry, coupled=_ls_multiple_coupled,
               segment=_ls_multiple_segment)[impl]
    out = run(ref, srv, filter_len, sample_rate, doppler_bins, solver)
    return out[0] if single else out


def ls_filter_multiple_graphed(ref: torch.Tensor, srv: torch.Tensor,
                               filter_len: int, sample_rate: float,
                               doppler_bins=(0,), solver: str = "levinson",
                               impl: str = "carry") -> torch.Tensor:
    """``ls_filter_multiple`` on tensors, as a replayed CUDA graph on the
    card (ops/graphs.graphed, kind "clutter"): the eager stage is a few
    hundred small launches a batch, the Levinson kernel among them, and a
    replay is one graph launch. The key holds the shapes, ``filter_len``,
    the sample rate, the bins, impl and solver, and the route. Every impl
    × solver is captured (cuSOLVER and cuBLAS calls too). The eager stage
    on CPU tensors and inside a graph being built. Returns a fresh
    tensor."""
    ref = ref.to(torch.complex64)
    srv = srv.to(device=ref.device, dtype=torch.complex64)
    params = (int(filter_len), float(sample_rate),
              tuple(float(b) for b in doppler_bins), impl, solver)
    return graphs.graphed(
        "clutter", lambda r, s: ls_filter_multiple(
            r, s, filter_len, sample_rate, doppler_bins, solver=solver,
            impl=impl), (ref, srv), params,
        info=dict(impl=impl, solver=solver))


def _ls_multiple_carry(ref, srv, filter_len, sample_rate, doppler_bins,
                       solver):
    n = ref.shape[-1]
    peek = 10
    m = filter_len + peek

    # every bin's Toeplitz system depends only on the modulated reference:
    # autocorrelations and solve data are computed up front, batched
    f_rs_all, heads, tails, f_extra = _modulated_ref_spectra(
        ref, n, m, peek, sample_rate, doppler_bins, extra=srv[:, None, :])
    ac_all = _guard(partial_ifft(f_rs_all * f_rs_all.conj(), m)
                    - _tri_corr_wrap(heads, tails, m))
    solve_xs, apply_inv = _solver_data(ac_all, m, solver)

    # Δcc kernels R_b[j, t] = conj(rs_b[t−j]) for t ≥ j
    zpad = torch.zeros(heads.shape[:-1] + (m + 1,), dtype=heads.dtype,
                       device=heads.device)
    r_all = _skew_toeplitz(torch.cat([heads.conj(), zpad], dim=-1), m)

    f_cur = f_extra[:, 0]
    ifft_head = srv[:, :m]
    corr = torch.zeros_like(ifft_head)
    for b in range(f_rs_all.shape[1]):
        f_rs, rs_tail, r_mat = f_rs_all[:, b], tails[:, b], r_all[:, b]
        cc = partial_ifft(f_cur * f_rs.conj(), m) + _mv(r_mat, corr) \
            - _tri_corr_wrap(ifft_head, rs_tail, m)
        taps = apply_inv(tuple(x[:, b] for x in solve_xs), cc)
        f_cur = f_cur - f_rs * sparse_fft(taps, n)
        head_fix = _tri_conv_wrap(taps, rs_tail, m)
        ifft_head = ifft_head - (_mv(r_mat.conj().transpose(-1, -2), taps)
                                 + head_fix)
        corr = corr + head_fix
    out = ifft_auto(f_cur)
    out[:, :m] += corr
    return out


@functools.cache
def _pair_index(nb: int, device: torch.device):
    """The ordered bin pairs a (earlier) → b (later), and their index
    tensors on ``device``."""
    pairs = [(a, b) for b in range(nb) for a in range(b)]
    return (pairs,
            torch.tensor([p[0] for p in pairs], dtype=torch.long,
                         device=device),
            torch.tensor([p[1] for p in pairs], dtype=torch.long,
                         device=device))


def _ls_multiple_coupled(ref, srv, filter_len, sample_rate, doppler_bins,
                         solver):
    """Precoupled formulation: the sequential passes are linear in the
    carried residual, so they unroll into

        taps_b = T_b⁻¹ (cc0_b − Σ_{a<b} M_ab·taps_a)
        out    = srv − Σ_b trunc_n(conv(rs_b, taps_b))
        M_ab[u, j] = G_ab[u−j] − (T_bᴴ T_a)[u, j]

    with every correlation taken the carry impl's way (circular spectra
    products, one batched zoom of 2·nb + 2·npairs rows, exact alias
    corrections). Only m-sized matvecs and solves stay serial.
    """
    n = ref.shape[-1]
    peek = 10
    m = filter_len + peek
    nb = len(doppler_bins)

    f_rs_all, heads, tails = _modulated_ref_spectra(
        ref, n, m, peek, sample_rate, doppler_bins)
    f_srv = fft_auto(srv)

    # rows: autocorrelations q_bb, cc0 f_srv·conj(f_rs_b), then G_ab and
    # G_ba for a < b
    pairs, ai, bi = _pair_index(nb, ref.device)
    rows = [f_rs_all * f_rs_all.conj(), f_srv[:, None] * f_rs_all.conj()]
    if pairs:
        q_pair = f_rs_all[:, ai] * f_rs_all[:, bi].conj()
        rows += [q_pair, q_pair.conj()]
    lags = partial_ifft(torch.cat(rows, dim=1), m)

    srv_heads = srv[:, None, :m].expand(heads.shape)
    ac_all = _guard(lags[:, :nb] - _tri_corr_wrap(heads, tails, m))
    cc0 = lags[:, nb:2 * nb] - _tri_corr_wrap(srv_heads, tails, m)
    npairs = len(pairs)
    m_pair = None
    if pairs:
        g_ab = lags[:, 2 * nb:2 * nb + npairs] \
            - _tri_corr_wrap(heads[:, ai], tails[:, bi], m)
        g_ba = lags[:, 2 * nb + npairs:] \
            - _tri_corr_wrap(heads[:, bi], tails[:, ai], m)
        # the Toeplitz part from the two-sided lags, G_ab[−u] = conj(G_ba[u])
        v = torch.cat([torch.flip(g_ba[..., 1:], [-1]).conj(), g_ab], dim=-1)
        t_all = _tail_toeplitz(tails, m)
        m_pair = _two_sided_toeplitz(v, m) - torch.einsum(
            "xprl,xprj->xplj", t_all[:, bi].conj(), t_all[:, ai])
    solve_xs, apply_inv = _solver_data(ac_all, m, solver)
    taps_all = _coupled_taps(cc0, m_pair, pairs, solve_xs, apply_inv)

    # one spectrum combine and one inverse transform
    f_clut = (f_rs_all * sparse_fft(taps_all, n)).sum(dim=1)
    out = ifft_auto(f_srv - f_clut)
    out[:, :m] += _tri_conv_wrap(taps_all, tails, m).sum(dim=1)
    return out


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _segment_geometry(n: int, m: int):
    """(F, L, H, K): segment FFT length, stride, halo and count. H ≥ m−1
    keeps lags 0..m−1 alias-free, L = F − H ≥ H keeps the overlap-add tails
    apart; F is SEGMENT_FFT_LEN capped at the problem size."""
    h = _round_up(max(m - 1, 1), 128)
    f = max(nextpow2(2 * h), min(SEGMENT_FFT_LEN, nextpow2(n)))
    l = f - h
    return f, l, h, -(-n // l)


def _seg_windows(x: torch.Tensor, f: int, l: int, h: int, k: int):
    """Overlap-save windows of (..., n) rows, zero-extended: ext[s] =
    x[s·l : s·l + f] and plain[s] = x[s·l : s·l + l] zero-padded to f, each
    (..., k, f)."""
    n = x.shape[-1]
    zp = torch.nn.functional.pad(x, (0, k * l + l - n))
    lead = x.shape[:-1]
    base = zp[..., :k * l].reshape(lead + (k, l))
    nxt = zp[..., l:l + k * l].reshape(lead + (k, l))[..., :h]
    ext = torch.cat([base, nxt], dim=-1)
    plain = torch.nn.functional.pad(base, (0, h))
    return ext, plain


def _modulated_refs(ref: torch.Tensor, n: int, peek: int,
                    sample_rate: float, doppler_bins) -> torch.Tensor:
    """rs_b = roll(ref·e^{j2πf_b t}, −peek) for every bin, (B, nb, n): the
    exact oscillator of ops/mixer.py for any fractional bin."""
    rows = [ref if float(f_b) == 0.0 else
            frequency_shift(ref, float(f_b), float(sample_rate))
            for f_b in doppler_bins]
    return torch.roll(torch.stack(rows, dim=1), -peek, dims=-1)


def _ls_multiple_segment(ref, srv, filter_len, sample_rate, doppler_bins,
                         solver):
    """Segment-Gram formulation of the same unrolled algebra as the coupled
    impl: every correlation (auto, cross, against srv) is

        corr_ab[u] = ifft(Σ_s FFT(ext_a[s])·conj(FFT(plain_b[s])))[u]

    over overlap-save segments of length F, so nothing runs at full length;
    the reconstruction is one overlap-add inverse of the bin-summed
    spectra.
    """
    n = ref.shape[-1]
    peek = 10
    m = filter_len + peek
    nb = len(doppler_bins)
    f, l, h, k = _segment_geometry(n, m)

    rs_all = _modulated_refs(ref, n, peek, sample_rate, doppler_bins)
    ext, plain = _seg_windows(torch.cat([srv[:, None], rs_all], dim=1),
                              f, l, h, k)
    e_spec = torch.fft.fft(ext, dim=-1)                 # (B, 1+nb, k, f)
    p_spec = torch.fft.fft(plain[:, 1:], dim=-1)        # (B, nb, k, f)

    gram = torch.einsum("xakf,xbkf->xabf", e_spec, p_spec.conj())
    lags = torch.fft.ifft(gram, dim=-1)[..., :m]        # (B, 1+nb, nb, m)
    cc0 = lags[:, 0]
    gpos = lags[:, 1:]                                  # G_ab[u ≥ 0]
    diag = torch.arange(nb, device=ref.device)
    ac_all = _guard(gpos[:, diag, diag])

    pairs, ai, bi = _pair_index(nb, ref.device)
    m_pair = None
    if pairs:
        # v[d + m−1] = G_ab[d], G_ab[−u] = conj(G_ba[u])
        neg = torch.flip(gpos[:, bi, ai, 1:], [-1]).conj()
        v = torch.cat([neg, gpos[:, ai, bi]], dim=-1)
        t_all = _tail_toeplitz(rs_all[..., n - m:], m)
        m_pair = _two_sided_toeplitz(v, m) - torch.einsum(
            "xprl,xprj->xplj", t_all[:, bi].conj(), t_all[:, ai])
    solve_xs, apply_inv = _solver_data(ac_all, m, solver)
    taps_all = _coupled_taps(cc0, m_pair, pairs, solve_xs, apply_inv)

    taps_f = torch.fft.fft(taps_all, n=f, dim=-1)       # (B, nb, f)
    seg = torch.fft.ifft(torch.einsum("xbkf,xbf->xkf", p_spec, taps_f),
                         dim=-1)                        # (B, k, f)
    b_ = seg.shape[0]
    main = seg[..., :l].reshape(b_, k * l)
    spill = torch.nn.functional.pad(seg[..., l:], (0, l - h)).reshape(
        b_, k * l)
    clut = main + torch.nn.functional.pad(spill, (l, 0))[:, :k * l]
    return srv - clut[:, :n]


# --------------------------------------------------------------------------
# single-bin block cancellers on the circular lag matrix
# --------------------------------------------------------------------------

def _circular_gram_and_rhs(ref, srv, filter_len: int, peek: int):
    """Gram Aᴴ A and right-hand side Aᴴ srv of the circular lag matrix whose
    columns are roll(ref, l), l = −peek..filter_len−1 (reference
    clutter_removal.py:31-37): AᴴA[a, b] = G[l_a − l_b], (Aᴴ srv)[a] =
    H[l_a], G and H circular correlations; no n×m matrix."""
    n = ref.shape[-1]
    lags = np.arange(-peek, filter_len)
    g = circular_corr_lags(ref, ref)
    hh = circular_corr_lags(srv, ref)
    d = torch.from_numpy(np.mod(lags[:, None] - lags[None, :], n)).to(
        ref.device)
    rhs_idx = torch.from_numpy(np.mod(lags, n)).to(ref.device)
    return g[..., d], hh[..., rhs_idx], lags


def _apply_circular_taps(ref, srv, taps, lags):
    """srv − Σ_a taps[a]·roll(ref, lags[a]) as one circular convolution."""
    n = ref.shape[-1]
    wpad = torch.zeros(ref.shape, dtype=taps.dtype, device=taps.device)
    wpad[..., torch.from_numpy(np.mod(lags, n)).to(taps.device)] = taps
    clutter = torch.fft.ifft(torch.fft.fft(ref, dim=-1)
                             * torch.fft.fft(wpad, dim=-1), dim=-1)
    return srv - clutter


def ls_filter(ref, srv, filter_len: int, reg: float = 1.0, peek: int = 10,
              return_filter: bool = False, device=None):
    """Direct block LS filter with Tikhonov regularisation ``reg``
    (reference clutter_removal.py:6-56) through the circular Gram. ref/srv
    (n,) or (B, n); numpy inputs go to ``device`` (the CUDA card by
    default)."""
    ref, srv = _as_pair(ref, srv, device)
    gram, rhs, lags = _circular_gram_and_rhs(ref, srv, filter_len, peek)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    taps = _solve_complex(gram + reg * eye, rhs)
    out = _apply_circular_taps(ref, srv, taps, lags)
    return (out, taps) if return_filter else out


def ls_filter_svd(ref, srv, filter_len: int, peek: int = 10,
                  return_filter: bool = False, device=None):
    """Pseudo-inverse block LS filter (reference clutter_removal.py:58-107):
    the eigendecomposition of the real 2m embedding of the Hermitian Gram;
    its eigenvalues are the lag matrix's squared singular values, and those
    whose square root is below the reference's 1e-10 cutoff are dropped.
    ref/srv (n,) or (B, n); numpy inputs go to ``device`` (the CUDA card by
    default)."""
    ref, srv = _as_pair(ref, srv, device)
    gram, rhs, lags = _circular_gram_and_rhs(ref, srv, filter_len, peek)
    m = gram.shape[-1]
    gr, gi = gram.real, gram.imag
    big = torch.cat([torch.cat([gr, -gi], dim=-1),
                     torch.cat([gi, gr], dim=-1)], dim=-2)
    evals, evecs = torch.linalg.eigh(big)
    inv = torch.where(torch.sqrt(torch.clamp(evals, min=0.0)) < 1e-10,
                      torch.zeros_like(evals),
                      1.0 / torch.clamp(evals, min=1e-30))
    rhs_big = torch.cat([rhs.real, rhs.imag], dim=-1)
    sol = _mv(evecs, inv * _mv(evecs.transpose(-1, -2), rhs_big))
    taps = torch.complex(sol[..., :m], sol[..., m:])
    out = _apply_circular_taps(ref, srv, taps, lags)
    return (out, taps) if return_filter else out


def nlms_filter(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
                mu: float, peek: int = 10, initial_taps=None,
                return_filter: bool = False):
    """Normalised LMS clutter canceller (reference clutter_removal.py:189-249)
    with the signature and semantics of the JAX ``nlms_filter`` scan.

    ref/srv: (n,) complex64. At step k the tap input is ref[k+1 : k+1+L+peek]
    (flipped in the reference's orientation), the error e = srv[k+L] − wᴴu
    becomes output sample L+k, and w ← w + mu·u·conj(e)/(uᴴu) with the plain
    division: an all-zero window makes the taps and every later output NaN,
    as in the scan. ``initial_taps`` and the returned taps are in the
    reference orientation; with ``initial_taps`` the filter length is its
    length less ``peek``. On a CUDA tensor it launches the NLMS kernel; on
    the CPU it runs the kernel's plain version.
    """
    if ref.dim() != 1:
        raise ValueError(f"nlms_filter takes 1-D ref and srv, got "
                         f"{tuple(ref.shape)}; nlms_filter_batch takes a "
                         "batch")
    return nlms_filter_batch(ref, srv, filter_len, mu, peek=peek,
                             return_filter=return_filter,
                             initial_taps=initial_taps, zero_window="nan")


def gal_jpe(ref, srv, lattice_len: int, delay_line_len: int, mu1: float,
            mu2: float, peek: int = 10, return_filter: bool = False,
            device=None):
    """Gradient adaptive lattice joint-process estimator (reference
    clutter_removal.py:251-364), the JAX ``gal_jpe`` scan as a loop over
    samples with the lattice stages as an inner loop; the reflection and
    tap updates are vectorised over the stages.

    ref/srv: (n,) or (B, n); numpy inputs go to ``device`` (the CUDA card
    by default). Output sample t is the error of step t, t < n − peek − 1,
    zero after. The step-size annealing uses |e|² where the reference's
    ``min(γμ1 + δe², 5e-3)`` is unorderable for complex e (identical for
    real signals), as the JAX package does. With ``return_filter`` also the
    final reflection coefficients and taps, each (…, delay_line_len).
    """
    if lattice_len > delay_line_len:
        raise ValueError("delay line must be at least as long as the lattice")
    ref, srv = _as_pair(ref, srv, device)
    lead = ref.shape[:-1]
    n = srv.shape[-1]
    lat, dl = lattice_len, delay_line_len
    beta, gamma, delta = 0.9, 0.999, 1e-8
    cplx = dict(dtype=torch.complex64, device=ref.device)
    b = torch.zeros(lead + (dl,), **cplx)
    k = torch.zeros(lead + (dl,), **cplx)
    p = torch.full(lead + (dl,), 1e-8, dtype=torch.float32, device=ref.device)
    h = torch.zeros(lead + (dl,), **cplx)
    mu1_t = torch.full(lead, mu1, dtype=torch.float32, device=ref.device)
    steps = n - peek - 1
    out = torch.zeros(lead + (n,), **cplx)
    for t in range(steps):
        x_ref = ref[..., t + peek]
        bo = b
        f_st, b_st = [x_ref], [x_ref]
        for s in range(1, lat):
            f_prev = f_st[-1]
            f_st.append(f_prev - k[..., s].conj() * bo[..., s - 1])
            b_st.append(bo[..., s - 1] - k[..., s] * f_prev)
        f = torch.stack(f_st, dim=-1)                      # (…, lat)
        b = torch.stack(b_st, dim=-1)
        if lat < dl:
            # delay-line continuation: b[s] = bo[s−1] for s ≥ lat
            b = torch.cat([b, bo[..., lat - 1:-1]], dim=-1)
        bo_l = bo[..., :lat - 1]
        em = f[..., :-1].abs() ** 2 + bo_l.abs() ** 2
        p_new = beta * p[..., :lat - 1] + (1.0 - beta ** 2) * em
        grad = f[..., :-1].conj() * b[..., 1:lat] \
            + bo_l * f[..., 1:lat].conj()
        k = torch.cat([k[..., :1], k[..., 1:lat]
                       + mu1_t[..., None] * grad / (p_new + 1e-10),
                       k[..., lat:]], dim=-1)
        p = torch.cat([p_new, p[..., lat - 1:]], dim=-1)
        e = srv[..., t] - (h.conj() * b).sum(-1)
        h = h + mu2 * e.conj()[..., None] * b / (
            (b.conj() * b).sum(-1).real[..., None] + 1e-10)
        mu1_t = torch.clamp(gamma * mu1_t + delta * e.abs() ** 2, max=5e-3)
        out[..., t] = e
    return (out, k, h) if return_filter else out
