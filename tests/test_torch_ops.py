"""The port's DSP operations against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its port
counterpart, at the tolerances the JAX package's own tests hold against
their scipy/numpy oracles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

torch.set_num_threads(1)

from passiveradar_tpu.ops import caf as jcaf  # noqa: E402
from passiveradar_tpu.ops import clutter as jclutter  # noqa: E402
from passiveradar_tpu.ops import mixer as jmixer  # noqa: E402
from passiveradar_tpu.ops.xcorr import find_channel_offset as \
    j_find_offset, xcorr as j_xcorr  # noqa: E402
from passiveradar_tpu.ops import zoomfft as jzoom  # noqa: E402
from passiveradar_tpu.parallel.halo import \
    overlap_frames as j_overlap  # noqa: E402
from passiveradar_torch.ops import caf as tcaf  # noqa: E402
from passiveradar_torch.ops import clutter as tclutter  # noqa: E402
from passiveradar_torch.ops import fft as tfft  # noqa: E402
from passiveradar_torch.ops import mixer as tmixer  # noqa: E402
from passiveradar_torch.ops.xcorr import apply_offset, \
    find_channel_offset as t_find_offset, xcorr as t_xcorr  # noqa: E402
from passiveradar_torch.ops import zoomfft as tzoom  # noqa: E402
from passiveradar_torch.ops.iir import iir_decimate  # noqa: E402
from passiveradar_torch.parallel.halo import \
    overlap_frames as t_overlap  # noqa: E402


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n,blen,fc,fs", [(12, 4_799_260, -100_000,
                                           2_400_000),
                                          (7, 24_576, 9_830, 49_152),
                                          (3, 1000, 0, 1000)])
def test_block_phase_offsets_equal(n, blen, fc, fs):
    np.testing.assert_array_equal(
        tmixer.block_phase_offsets(n, blen, fc, fs),
        jmixer.block_phase_offsets(n, blen, fc, fs))


def test_frequency_shift_batched(rng):
    x = _cn(rng, 3, 5000)
    ph = rng.standard_normal(3).astype(np.float32)
    want = np.asarray(jmixer.frequency_shift(jnp.asarray(x), 12_345.0,
                                             96_000.0, jnp.asarray(ph)))
    got = tmixer.frequency_shift(_t(x), 12_345.0, 96_000.0, _t(ph)).numpy()
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("q,tol", [(1, 5e-6), (2, 5e-6), (4, 1e-5),
                                   (8, 5e-5), (16, 5e-4)])
def test_iir_decimate_matches_scipy(rng, q, tol):
    """Same oracle and tolerances as the JAX package's iir test; q=16
    takes the biquad-cascade path."""
    x = _cn(rng, 30_000)
    want = (sps.filtfilt(*sps.cheby1(8, 0.05, 0.8), x) if q == 1
            else sps.decimate(x, q))
    got = iir_decimate(_t(x), q).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < tol * np.max(np.abs(want))


@pytest.mark.parametrize("offset,nd,max_fft", [(37, 1, 1 << 22),
                                               (-120, 2, 1 << 22),
                                               (1500, 1, 1 << 13)])
def test_find_channel_offset_exact(rng, offset, nd, max_fft):
    """Exact integer offset, equal to JAX's; max_fft = 2^13 forces the
    coarse-then-refine path (needed FFT 2^14 > max_fft)."""
    n = 6000
    base = _cn(rng, n + abs(offset))
    s1 = base[abs(offset) - offset:abs(offset) - offset + n] if offset > 0 \
        else base[:n]
    s2 = base[abs(offset):abs(offset) + n] if offset > 0 \
        else base[-offset:-offset + n]
    s2 = np.ascontiguousarray(s2 + 0.01 * _cn(rng, n))
    s1 = np.ascontiguousarray(s1)
    want = j_find_offset(s1, s2, nd, 4000, max_fft)
    got = t_find_offset(s1, s2, nd, 4000, max_fft, device="cpu")
    assert got == want
    r1, r2 = apply_offset(s1, s2, got)
    assert r1.shape == r2.shape


def test_xcorr_matches_jax(rng):
    s1, s2 = _cn(rng, 700), _cn(rng, 700)
    want = np.asarray(j_xcorr(jnp.asarray(s1), jnp.asarray(s2), 20, 7))
    got = t_xcorr(_t(s1), _t(s2), 20, 7).numpy()
    assert _rel(got, want) < 1e-5


def test_partial_ifft_and_sparse_fft(rng):
    x = _cn(rng, 2, 4096)
    want = np.asarray(jzoom.partial_ifft(jnp.asarray(x), 185))
    got = tzoom.partial_ifft(_t(x), 185).numpy()
    assert _rel(got, want) < 1e-5
    s = _cn(rng, 2, 185)
    want = np.asarray(jzoom.sparse_fft(jnp.asarray(s), 4096))
    got = tzoom.sparse_fft(_t(s), 4096).numpy()
    assert _rel(got, want) < 1e-5


def test_dft_matmul_contract(rng):
    """mxufft.dft_matmul's sliced contract (pad to n, first out_len
    outputs, non-pow2 n) on the torch.fft route."""
    from passiveradar_tpu.ops.mxufft import dft_matmul
    x = _cn(rng, 3, 700)
    for inverse in (False, True):
        want = np.asarray(dft_matmul(jnp.asarray(x), axis=-1, inverse=inverse,
                                     n=768, out_len=177))
        got = tfft.dft_matmul(_t(x), dim=-1, inverse=inverse, n=768,
                              out_len=177).numpy()
        assert _rel(got, want) < 1e-5


def test_levinson_first_col_matches_jax(rng):
    m, batch = 40, 6
    cols = []
    for _ in range(batch):
        s = _cn(rng, 500)
        cols.append(np.correlate(s, s, "full")[499:499 + m])
    c = np.stack(cols).astype(np.complex64)
    want = np.asarray(jclutter.levinson_first_col(jnp.asarray(c)))
    got = tclutter.levinson_first_col(_t(c)).numpy()
    assert _rel(got, want) < 1e-4


def test_gs_apply_solves_toeplitz(rng):
    """Levinson + Gohberg-Semencul apply vs scipy.linalg.solve_toeplitz,
    at the JAX test's 2e-3 bound."""
    from scipy.linalg import solve_toeplitz
    m = 30
    s = _cn(rng, 400).astype(np.complex128)
    ac = np.correlate(s, s, "full")[399:399 + m]
    v = _cn(rng, m).astype(np.complex128) * np.abs(ac[0])
    x = tclutter.levinson_first_col(_t(ac.astype(np.complex64))[None])
    fx, fy, delta = tclutter.gs_generators(x, 64)
    got = tclutter.gs_apply(fx, fy, delta, _t(v.astype(np.complex64))[None])
    want = solve_toeplitz(ac, v)
    assert _rel(got.numpy()[0], want) < 2e-3


@pytest.mark.parametrize("bins,fs", [((0, 1, -1, 2, -2), 8192.0),
                                     ((0, 1.002), 8192.0),
                                     ((0, 3.3), 8192.0)])
def test_ls_filter_multiple_matches_jax(rng, bins, fs):
    """Port vs JAX (carry, levinson) at the JAX solver-equivalence bound.
    Integer bins take the first-order Taylor ramp, 1.002 Hz the
    second-order one, 3.3 Hz the direct per-bin (order-0) spectra."""
    n, flen = 8192, 24
    ref = _cn(rng, n)
    srv = (np.roll(ref, 2) + 0.05 * _cn(rng, n)).astype(np.complex64)
    want = np.asarray(jclutter.ls_filter_multiple(ref, srv, flen, fs, bins))
    got = tclutter.ls_filter_multiple(_t(ref), _t(srv), flen, fs,
                                      bins).numpy()
    assert np.max(np.abs(got - want)) < 2e-3 * np.max(np.abs(srv))
    # the canceller removed the direct path
    assert np.linalg.norm(got) < 0.2 * np.linalg.norm(srv)


def test_ls_filter_multiple_batched_and_zero_frame(rng):
    """A batch holding an all-zero frame (the pipeline's margin frames)
    stays finite, and the live frame equals its unbatched result."""
    n, flen = 2048, 16
    ref = _cn(rng, n)
    srv = (np.roll(ref, 1) + 0.1 * _cn(rng, n)).astype(np.complex64)
    z = np.zeros(n, np.complex64)
    out = tclutter.ls_filter_multiple(_t(np.stack([ref, z])),
                                      _t(np.stack([srv, z])), flen, 2048.0,
                                      (0, 1, -1)).numpy()
    assert np.all(np.isfinite(out))
    assert np.max(np.abs(out[1])) == 0.0
    single = tclutter.ls_filter_multiple(_t(ref), _t(srv), flen, 2048.0,
                                         (0, 1, -1)).numpy()
    assert np.max(np.abs(out[0] - single)) < 1e-5 * np.max(np.abs(srv))


def test_overlap_frames_equal(rng):
    x = _cn(rng, 5, 64)
    want = np.asarray(j_overlap(jnp.asarray(x), 16))
    got = t_overlap(_t(x), 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,nf,r,window", [(8192, 128, 20, None),
                                           (8192, 128, 20, ("kaiser", 5.0)),
                                           (4096, 256, 40, None)])
def test_fast_xambg_matches_jax(rng, n, nf, r, window):
    ref, srv = _cn(rng, n), _cn(rng, n)
    want = np.asarray(jcaf.fast_xambg(ref, srv, r, nf, window=window))
    got = tcaf.fast_xambg(_t(ref), _t(srv), r, nf, window=window).numpy()
    assert got.shape == (nf, r + 1)
    assert _rel(got, want) < 1e-5


def test_fast_xambg_batched(rng):
    ref, srv = _cn(rng, 3, 4096), _cn(rng, 3, 4096)
    got = tcaf.fast_xambg(_t(ref), _t(srv), 30, 128).numpy()
    for f in range(3):
        want = np.asarray(jcaf.fast_xambg(ref[f], srv[f], 30, 128))
        assert _rel(got[f], want) < 1e-5
