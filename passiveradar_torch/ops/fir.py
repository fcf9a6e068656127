"""FIR filtering, polyphase rational resampling and decimation.

Port of the JAX package's ops/fir.py. Filter design and every alignment and
edge constant are float64 host numpy, re-derived exactly as the JAX package
derives them (``scipy.signal.resample_poly`` semantics, including the
``padtype='line'`` linear-trend extension). The compute is torch:

* ``upfirdn`` / ``resample_poly`` / ``fir_decimate`` / ``decimate_taps`` —
  the phase-grouped matmul formulation on strided windows (used by the
  channel-offset search);
* ``mix_resample_poly_batch`` — the fused mixer+resampler of the main path
  (``mix_resample_poly``: one frame).
  Its bulk is the hand-written CUDA kernel ``ops/resample_kernel.py``
  (the Pallas ``mix_regroup_matmul`` of the JAX package) at fold = 1: the
  phase-folded banks of ``_mix_resample_fold`` are a TPU factorisation and
  are not ported. The epilogue (per-group oscillator scale ``fg``, the
  'line' edge corrections on the flat output, the trim and the per-frame
  phase) stays in torch ops around the kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import signal as _spsignal

from passiveradar_torch._device import on_device
from passiveradar_torch.ops import resample_kernel
from passiveradar_torch.ops.mixer import frequency_shift, phase_rotor
from passiveradar_torch.ops.resample_kernel import pack_bank
from passiveradar_torch.ops.util import as_complex, iq_pairs


def design_lowpass(numtaps: int, cutoff: float, window) -> np.ndarray:
    """Windowed-sinc lowpass design (``scipy.signal.firwin``), float64."""
    return _spsignal.firwin(numtaps, cutoff, window=window)


def _upfirdn_output_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """Number of output samples of upfirdn (full conv of dilated input)."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _polyphase_bank(h: np.ndarray, up: int, down: int):
    """Phase-grouped float64 tap bank: out[g·up + p] = Σ_wi B[p, wi] ·
    x[g·down + q_min + wi], B[p, wi] = h[p·down − (wi + q_min)·up]."""
    len_h = len(h)
    q_min = min((p * down - (len_h - 1)) // up for p in range(up))
    q_max = max((p * down) // up for p in range(up))
    w = q_max - q_min + 1
    bank = np.zeros((up, w), dtype=np.float64)
    for p in range(up):
        for qi in range(w):
            j = p * down - (qi + q_min) * up
            if 0 <= j < len_h:
                bank[p, qi] = h[j]
    return bank, q_min, w


def _upfirdn_core(x: torch.Tensor, h: np.ndarray, up: int,
                  down: int) -> torch.Tensor:
    """Zero-edge upfirdn of (..., n) complex rows as one strided-window matmul."""
    n_in = x.shape[-1]
    n_out = _upfirdn_output_len(len(h), n_in, up, down)
    bank, q_min, w = _polyphase_bank(h, up, down)
    groups = -(-n_out // up)
    pad_l = -q_min
    total = (groups - 1) * down + w
    xp = torch.nn.functional.pad(x, (pad_l, max(0, total - n_in - pad_l)))
    win = xp[..., :total].unfold(-1, w, down)           # (..., groups, w)
    b = torch.from_numpy(bank.astype(np.float32)).to(
        device=x.device, dtype=x.dtype)
    out = torch.matmul(win, b.T)                          # (..., groups, up)
    return out.reshape(x.shape[:-1] + (groups * up,))[..., :n_out]


def upfirdn(h: np.ndarray, x: torch.Tensor, up: int = 1, down: int = 1,
            mode: str = "constant") -> torch.Tensor:
    """Upsample by ``up``, FIR filter with ``h``, downsample by ``down``.

    Matches scipy.signal.upfirdn along the last axis for modes 'constant'
    and 'line'. Real input stays real, complex stays complex64.
    """
    h = np.asarray(h, np.float64)
    xc = x.to(torch.complex64 if x.is_complex() else torch.float32)
    if mode == "line":
        n_in = xc.shape[-1]
        need = -(-len(h) // up)
        ext = down * (-(-need // down))
        slope = (xc[..., -1:] - xc[..., :1]) / max(n_in - 1, 1)
        kl = torch.arange(ext, 0, -1, dtype=torch.float32, device=x.device)
        kr = torch.arange(1, ext + 1, dtype=torch.float32, device=x.device)
        xe = torch.cat([xc[..., :1] - slope * kl, xc,
                        xc[..., -1:] + slope * kr], dim=-1)
        shift = ext * up // down
        n_out = _upfirdn_output_len(len(h), n_in, up, down)
        return _upfirdn_core(xe, h, up, down)[..., shift:shift + n_out]
    if mode != "constant":
        raise ValueError(f"unsupported upfirdn mode {mode!r}")
    return _upfirdn_core(xc, h, up, down)


def _resample_design(n_in: int, up: int, down: int, window):
    """Tap design + alignment arithmetic of resample_poly (host, float64).

    Returns (h_pad, n_pre_remove, n_out): the zero-padded taps fed to
    upfirdn, the leading outputs to drop, and the final output length.
    """
    if isinstance(window, np.ndarray):
        h = np.array(window, dtype=np.float64)
        half_len = (len(h) - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = design_lowpass(2 * half_len + 1, 1.0 / max_rate, window)
    h = h * up
    n_out = n_in * up // down + bool((n_in * up) % down)
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _upfirdn_output_len(len(h) + n_pre_pad + n_post_pad, n_in,
                              up, down) < n_out + n_pre_remove:
        n_post_pad += 1
    h_pad = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    return h_pad, n_pre_remove, n_out


@functools.lru_cache(maxsize=64)
def _resample_taps(n_in: int, up: int, down: int, window) -> tuple:
    """``_resample_design`` for a window given by name (hashable), designed
    once: (the padded taps' float64 bytes, n_pre_remove, n_out). The main
    path's design is scipy's firwin over 2,381 Kaiser taps at FM: host time
    that no batch needs to pay again."""
    h_pad, n_pre_remove, n_out = _resample_design(n_in, up, down, window)
    return (np.ascontiguousarray(h_pad, np.float64).tobytes(), n_pre_remove,
            n_out)


def resample_poly(x: torch.Tensor, up: int, down: int,
                  window=("kaiser", 5.0), padtype: str = "constant"):
    """Rational polyphase resampling along the last axis, matching
    scipy.signal.resample_poly (reference signal_utils.py:15-17)."""
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == 1 and down == 1:
        return x
    h_pad, n_pre_remove, n_out = _resample_design(x.shape[-1], up, down,
                                                  window)
    y = upfirdn(h_pad, x, up, down, mode=padtype)
    return y[..., n_pre_remove:n_pre_remove + n_out]


@functools.lru_cache(maxsize=64)
def _mix_resample_static(h_bytes: bytes, up: int, down: int, c: float,
                         n_in: int, mode: str):
    """Host float64 constants of the fused mix+resample.

    ``h_bytes`` is the float64 tap vector's bytes (hashable cache key). The
    oscillator F(n) = e^{j2πcn} factors across the polyphase window into a
    static complex bank B̃ = B·Fw (``bank_ri`` = [Re B̃; Im B̃], float32) and a
    per-group scale ``fg``. For padtype='line' the linear-trend extension
    samples are linear in the first/last mixed samples m0/mN, so their
    contribution to the edge groups is the static correction pair
    ``corr`` = (gl, g_r0, C1_left, C2_left, C1_right, C2_right):
    out_edge += C1·m0 + C2·mN. Same arithmetic as the JAX package, element
    for element.
    """
    h = np.frombuffer(h_bytes, np.float64)
    len_h = len(h)
    _, q_min, w = _polyphase_bank(h, up, down)
    pad_l = -q_min
    if mode == "line":
        need = -(-len_h // up)
        ext = down * (-(-need // down))
    else:
        ext = 0
    L = n_in + 2 * ext
    n_out_full = _upfirdn_output_len(len_h, L, up, down)
    groups = -(-n_out_full // up)
    n_slabs = -(-w // down)
    W = n_slabs * down

    bank = np.zeros((up, W), dtype=np.float64)
    for p in range(up):
        for qi in range(w):
            j = p * down - (qi + q_min) * up
            if 0 <= j < len_h:
                bank[p, qi] = h[j]

    kk = np.arange(W, dtype=np.float64)
    fw = np.exp(2j * np.pi * np.mod(c * (kk - pad_l - ext), 1.0))
    bank_c = bank * fw
    bank_ri = np.concatenate([bank_c.real, bank_c.imag], axis=0).astype(
        np.float32)

    gd = np.arange(groups, dtype=np.float64) * down
    fg = np.exp(2j * np.pi * np.mod(c * gd, 1.0)).astype(np.complex64)

    corr = None
    if mode == "line" and n_in > 1:
        nm1 = n_in - 1
        fN = np.exp(2j * np.pi * np.mod(c * nm1, 1.0))
        gl = min(groups, (ext + pad_l + down - 1) // down)
        g_r0 = max(0, -(-(ext + n_in + pad_l - W + 1) // down))
        g_r0 = min(g_r0, groups)

        def edge(gs, left: bool):
            nu = gs[:, None] * down + np.arange(W)[None, :] - pad_l
            if left:
                m = (nu >= 0) & (nu < ext)
                a = (m * 1.0) @ bank.T
                d = (m * (ext - nu)) @ bank.T
                return a + d / nm1, (-d / nm1) * fN
            m = (nu >= ext + n_in) & (nu < ext + n_in + ext)
            a = (m * 1.0) @ bank.T
            d = (m * (nu - ext - n_in + 1)) @ bank.T
            return -d / nm1, (a + d / nm1) * fN

        c1l, c2l = edge(np.arange(gl), True)
        c1r, c2r = edge(np.arange(g_r0, groups), False)
        corr = (gl, g_r0,
                c1l.astype(np.complex64), c2l.astype(np.complex64),
                c1r.astype(np.complex64), c2r.astype(np.complex64))

    shift = ext * up // down if mode == "line" else 0
    n_out_plain = _upfirdn_output_len(len_h, n_in, up, down)
    return dict(pad_l=pad_l, ext=ext, groups=groups, n_slabs=n_slabs,
                bank_ri=bank_ri, bank_c64=bank_c, fg=fg, corr=corr,
                shift=shift, n_out_plain=n_out_plain)


@functools.cache
def _static_tensors(h_bytes: bytes, up: int, down: int, c: float, n_in: int,
                    mode: str, device: torch.device):
    """The device-resident operands of ``_mix_resample_static``, the bank
    packed for the kernel (``pack_bank``: its taps, phase table and real
    factors). Kept (unbounded: a replayed CUDA graph reads them by
    address, ops/graphs.py)."""
    st = _mix_resample_static(h_bytes, up, down, c, n_in, mode)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    corr = None
    if st["corr"] is not None:
        gl, g_r0, c1l, c2l, c1r, c2r = st["corr"]
        corr = (gl * up, g_r0 * up, to(c1l.reshape(-1)), to(c2l.reshape(-1)),
                to(c1r.reshape(-1)), to(c2r.reshape(-1)))
    return dict(bank=pack_bank(to(st["bank_ri"]), up), fg=to(st["fg"]),
                corr=corr)


def mix_resample_poly_batch(x: torch.Tensor, phases, fc: float, fs: float,
                            up: int, down: int, window=("kaiser", 5.0),
                            padtype: str = "constant") -> torch.Tensor:
    """Fused frequency shift + rational resample over a frame batch.

    x: (F, n) complex64 or (F, n, 2) float32 IQ pairs; phases: (F,) float32
    per-frame mixing phases. Equivalent (to float32 rounding) to
    resample_poly(frequency_shift(x_f, fc, fs, phase_f), up, down, window,
    padtype) per frame; the mixed signal is never materialised. The
    polyphase regroup+matmul runs in ``mix_regroup_matmul`` (the CUDA kernel
    on a CUDA tensor). Returns (F, n_out) complex64.
    """
    g = math.gcd(int(up), int(down))
    upr, downr = int(up) // g, int(down) // g
    ph = torch.as_tensor(phases, dtype=torch.float32, device=x.device)
    if upr == 1 and downr == 1:
        return frequency_shift(as_complex(x), fc, fs, ph)
    pairs = iq_pairs(x)
    f, n_in = pairs.shape[0], pairs.shape[1]
    if isinstance(window, (str, tuple)):
        h_bytes, n_pre_remove, n_out = _resample_taps(n_in, upr, downr,
                                                      window)
    else:
        h_pad, n_pre_remove, n_out = _resample_design(n_in, upr, downr,
                                                      window)
        h_bytes = np.ascontiguousarray(h_pad, np.float64).tobytes()
    c = float(fc) / float(fs)
    st = _mix_resample_static(h_bytes, upr, downr, c, n_in, padtype)
    dt = _static_tensors(h_bytes, upr, downr, c, n_in, padtype, x.device)
    groups = st["groups"]
    # looked up at call time: the key of a replayed batch graph holds it
    o = resample_kernel.mix_regroup_matmul(pairs, dt["bank"], downr, groups,
                                           upr,
                                           pad_left=st["pad_l"] + st["ext"])
    flat = (o * dt["fg"][None, :, None]).reshape(f, groups * upr)
    if dt["corr"] is not None:
        tl, t_r0, c1l, c2l, c1r, c2r = dt["corr"]
        xc = torch.view_as_complex(pairs)
        m0, mn = xc[:, :1], xc[:, -1:]
        if tl:
            flat[:, :tl] += c1l[None] * m0 + c2l[None] * mn
        t_hi = t_r0 + c1r.shape[0]
        if t_r0 < t_hi:
            flat[:, t_r0:t_hi] += c1r[None] * m0 + c2r[None] * mn
    lo = st["shift"] + n_pre_remove
    return flat[:, lo:lo + n_out] * phase_rotor(ph)[:, None]


def fir_decimate(x: torch.Tensor, q: int, numtaps: int | None = None,
                 window: str = "hamming") -> torch.Tensor:
    """Zero-phase FIR decimation by ``q`` along the last axis, matching
    scipy.signal.decimate(x, q, n=numtaps, ftype='fir') (numtaps is the
    filter order, default 20·q; reference signal_utils.py:11-13)."""
    q = int(q)
    if q == 1:
        return x
    if numtaps is None:
        numtaps = 20 * q
    taps = design_lowpass(numtaps + 1, 1.0 / q, window)
    return resample_poly(x, 1, q, window=taps)


def decimate_taps(x, taps, q: int, device=None) -> torch.Tensor:
    """Zero-phase decimation by ``q`` with explicit FIR taps along the last
    axis, matching scipy.signal.decimate(x, q, ftype=dlti(taps, 1)) (the
    reference CAF's Doppler decimator, range_doppler_processing.py:69-86):
    out[g] = Σ_j taps[j]·x[g·q + (len(taps)−1)//2 − j], x zero outside.
    Numpy input goes to ``device`` (the CUDA card by default)."""
    return resample_poly(on_device(x, device), 1, int(q),
                         window=np.asarray(taps, dtype=np.float64))


def mix_resample_poly(x, fc: float, fs: float, phase, up: int, down: int,
                      window=("kaiser", 5.0), padtype: str = "constant",
                      device=None) -> torch.Tensor:
    """Fused frequency shift + rational resample of one frame:
    ``mix_resample_poly_batch`` on a batch of one. x: (n,) complex or (n, 2)
    float IQ pairs (numpy goes to ``device``, the CUDA card by default);
    ``phase`` the starting phase in radians."""
    x = on_device(x, device)
    ph = torch.as_tensor(phase, dtype=torch.float32).reshape(1)
    return mix_resample_poly_batch(x[None], ph, fc, fs, up, down, window,
                                   padtype)[0]
