"""Clutter cancellation: multi-Doppler-bin least squares and NLMS.

Port of the parts of the JAX package's ops/clutter.py that the pipeline
runs: ``ls_filter_multiple`` with impl='carry' and solver='levinson'
(reference clutter_removal.py:162-187, bins (0, 1, -1, 2, -2) Hz,
main.py:174), and the ``nlms_filter`` adaptive canceller (reference
clutter_removal.py:189-249) on the CUDA kernel of ops/nlms_kernel.py. Every
function takes a leading batch of frames: the JAX package's vmap over
frames becomes the leading axis, and the ``lax.scan`` over Doppler bins a Python loop.

Per bin the Toeplitz normal equations of the lag-matrix LS problem are
built from circular FFT correlations with exact triangular alias
corrections (the *_wrap helpers), solved by Levinson-Durbin + the
Gohberg-Semencul generators, and the residual is carried in the frequency
domain plus an m-sample time-domain head correction.
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch.config import nextpow2
from passiveradar_torch.ops.fft import fft_auto, ifft_auto
from passiveradar_torch.ops.nlms_kernel import nlms_filter_batch
from passiveradar_torch.ops.zoomfft import partial_ifft, sparse_fft


def _mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., a, b) @ (..., b) → (..., a)."""
    return torch.matmul(mat, v.unsqueeze(-1)).squeeze(-1)


def levinson_first_col(c: torch.Tensor) -> torch.Tensor:
    """First column x = T⁻¹e₀ of each Hermitian Toeplitz T, batched.

    ``c`` (..., m) is the first column of each T. Levinson-Durbin over the
    order: m−1 dependent steps on a (batch, m) state (reference analog:
    scipy.solve_toeplitz, clutter_removal.py:109-160). ``ar`` carries the
    reversed-conjugate polynomial, updated by a one-sample shift.
    """
    batch = c.shape[:-1]
    m = c.shape[-1]
    cb = c.reshape(-1, m)
    nb = cb.shape[0]
    z = torch.zeros((nb, m), dtype=cb.dtype, device=cb.device)
    # cf_pad[:, 2m-1-k+j] = c[k-j] (zero outside 0..m-1)
    cf_pad = torch.cat([z, torch.flip(cb, [-1]), z], dim=-1)
    a = torch.zeros_like(cb)
    a[:, 0] = 1.0
    e = cb[:, 0].real.clone()
    ar = torch.nn.functional.pad(a[:, :-1], (1, 0))
    for k in range(1, m):
        crev = cf_pad[:, 2 * m - 1 - k:3 * m - 1 - k]
        acc = (a * crev).sum(-1)
        kap = -acc / e
        a_new = a + kap[:, None] * ar
        ar = torch.nn.functional.pad((ar + kap.conj()[:, None] * a)[:, :-1],
                                     (1, 0))
        e = e * (1.0 - kap.abs() ** 2)
        a = a_new
    return (a / e[:, None]).reshape(batch + (m,))


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


def _skew_toeplitz(e: torch.Tensor, m: int) -> torch.Tensor:
    """H[..., j, t] = e[..., (t−j) mod (2m+1)] from the (..., 2m+1)
    diagonal table, built by tiling and a row-stride-2m reshape."""
    lead = e.shape[:-1]
    tiled = e.unsqueeze(-2).expand(lead + (m, 2 * m + 1))
    flat = tiled.reshape(lead + (m * (2 * m + 1),))
    return flat[..., :2 * m * m].reshape(lead + (m, 2 * m))[..., :m]


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


def _phase_tab(mus, tau: np.ndarray, n: int, device) -> torch.Tensor:
    cyc = np.mod(np.outer(np.asarray(mus), tau / n), 1.0)
    return torch.from_numpy(np.exp(2j * np.pi * cyc).astype(
        np.complex64)).to(device)


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
    tau_h = np.arange(peek, peek + m, dtype=np.float64)
    tau_t = np.arange(n - m + peek, n + peek, dtype=np.float64)
    tau_t = np.where(tau_t < n, tau_t, tau_t - n)
    heads = head_base[:, None, :] * _phase_tab(mus, tau_h, n, dev)[None]
    tails = tail_base[:, None, :] * _phase_tab(mus, tau_t, n, dev)[None]

    if order == 0:
        t32 = torch.arange(n, dtype=torch.float32, device=dev) / float(
            np.float32(sample_rate))
        fb = torch.tensor(np.asarray(bins, np.float32), device=dev)
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
    ramp = torch.from_numpy(np.exp(
        2j * np.pi * np.mod(np.arange(n, dtype=np.float64) * peek / n, 1.0)
    ).astype(np.complex64)).to(dev)                      # time roll by -peek
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


def ls_filter_multiple(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
                       sample_rate: float, doppler_bins=(0,),
                       solver: str = "levinson",
                       impl: str = "carry") -> torch.Tensor:
    """Sequential per-Doppler-bin LS passes, frequency-domain residual carry.

    ref/srv: (n,) or (B, n) complex64. Only impl='carry' with
    solver='levinson' (the pipeline's defaults) is ported.
    """
    if impl != "carry" or solver != "levinson":
        raise NotImplementedError(
            f"ls_filter_multiple impl={impl!r} solver={solver!r}: only "
            "impl='carry', solver='levinson' is ported")
    single = ref.dim() == 1
    if single:
        ref, srv = ref[None], srv[None]
    ref = ref.to(torch.complex64)
    srv = srv.to(torch.complex64)
    n = ref.shape[-1]
    peek = 10
    m = filter_len + peek

    # every bin's Toeplitz system depends only on the modulated reference:
    # autocorrelations and solve generators are computed up front, batched
    f_rs_all, heads, tails, f_extra = _modulated_ref_spectra(
        ref, n, m, peek, sample_rate, doppler_bins, extra=srv[:, None, :])
    ac_all = partial_ifft(f_rs_all * f_rs_all.conj(), m) \
        - _tri_corr_wrap(heads, tails, m)
    # vanishing-diagonal guard: rounded away for real captures, keeps the
    # solve finite for all-zero frames (the pipeline's margin/padding frames)
    guard = 1e-25 * torch.clamp(ac_all[..., 0].abs(), min=1.0)
    ac_all[..., 0] += guard
    x_all = levinson_first_col(ac_all)
    fx_all, fy_all, delta_all = gs_generators(x_all, nextpow2(2 * m))

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
        taps = gs_apply(fx_all[:, b], fy_all[:, b], delta_all[:, b], cc)
        f_cur = f_cur - f_rs * sparse_fft(taps, n)
        head_fix = _tri_conv_wrap(taps, rs_tail, m)
        ifft_head = ifft_head - (_mv(r_mat.conj().transpose(-1, -2), taps)
                                 + head_fix)
        corr = corr + head_fix
    out = ifft_auto(f_cur)
    out[:, :m] += corr
    return out[0] if single else out


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
