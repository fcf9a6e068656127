"""The port's clutter cancellers, Toeplitz solvers and GAL-JPE against the
JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its port
counterpart, at the sizes and tolerances of tests/test_clutter.py, whose
float64 oracles (the sequential Toeplitz passes, the lag matrices) are
copied here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps
from scipy.linalg import solve_toeplitz

torch.set_num_threads(1)

from passiveradar_tpu.ops import clutter as jc  # noqa: E402
from passiveradar_torch.ops import clutter as tc  # noqa: E402

IMPLS = ("carry", "coupled", "segment")
SOLVERS = ("levinson", "gs_matrix", "gs_dense", "cholesky")


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _echo(rng, n, lag=2, noise=0.05):
    ref = _cn(rng, n)
    srv = (np.roll(ref, lag) + noise * _cn(rng, n)).astype(np.complex64)
    return ref, srv


def _xcorr_ref(s1, s2, nlead, nlag):
    return sps.correlate(s1, np.pad(s2, (nlag, nlead)), mode="valid")


def toeplitz_oracle(ref, srv, filter_len, peek=10):
    """The reference's Toeplitz pass in float64 (tests/test_clutter.py)."""
    ref = ref.astype(np.complex128)
    srv = srv.astype(np.complex128)
    rs = np.roll(ref, -peek)
    ac = _xcorr_ref(rs, rs, 0, filter_len + peek - 1)
    cc = _xcorr_ref(srv, rs, 0, filter_len + peek - 1)
    taps = solve_toeplitz(ac, cc)
    clutter = np.convolve(rs, taps, mode="full")[:len(srv)]
    return srv - clutter, taps


def lag_matrix(ref, filter_len, peek):
    """The reference's circular lag matrix (tests/test_clutter.py)."""
    lags = np.arange(-peek, filter_len)
    a = np.zeros((len(ref), filter_len + peek), dtype=np.complex128)
    for k, lag in enumerate(lags):
        a[:, k] = np.roll(ref, lag)
    return a


def _sequential_oracle(ref, srv, flen, fs, bins):
    """float64 sequential per-bin Toeplitz passes (tests/test_clutter.py)."""
    n = len(ref)
    cur = srv.astype(np.complex128)
    t = np.arange(n) / fs
    for dop in bins:
        r = ref.astype(np.complex128)
        if dop:
            r = r * np.exp(1j * 2 * np.pi * dop * t)
        cur, _ = toeplitz_oracle(r.astype(np.complex64),
                                 cur.astype(np.complex64), flen)
    return cur


def _lsm(ref, srv, flen, fs, bins, **kw):
    return tc.ls_filter_multiple(_t(ref), _t(srv), flen, fs, bins,
                                 **kw).numpy()


@pytest.mark.parametrize("solver", SOLVERS[1:])
def test_solver_equivalence(rng, solver):
    """Every solver against 'levinson' on the port and each against its
    JAX counterpart: n = 8192, 3 bins, 2e-3 of the peak |srv|."""
    n, flen, fs, bins = 8192, 24, 8192.0, (0, 1, -1)
    ref, srv = _echo(rng, n)
    base = _lsm(ref, srv, flen, fs, bins, solver="levinson")
    got = _lsm(ref, srv, flen, fs, bins, solver=solver)
    want = np.asarray(jc.ls_filter_multiple(ref, srv, flen, fs, bins,
                                            solver=solver))
    bound = 2e-3 * np.max(np.abs(srv))
    assert np.max(np.abs(got - base)) < bound
    assert np.max(np.abs(got - want)) < bound


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_matches_sequential_oracle(rng, solver):
    n, flen, fs, bins = 4096, 16, 4096.0, (0, 1, -1)
    ref, srv = _echo(rng, n)
    got = _lsm(ref, srv, flen, fs, bins, solver=solver)
    want = _sequential_oracle(ref, srv, flen, fs, bins)
    assert np.max(np.abs(got - want)) < 5e-3 * np.max(np.abs(srv))


@pytest.mark.parametrize("impl", IMPLS[1:])
def test_impl_matches_carry_and_jax(rng, impl):
    """'coupled' and 'segment' against 'carry' (FM-like fractional bins,
    the first-order ramp) and against the JAX impl: 2e-3."""
    n, flen = 4096, 16
    fs = n / 0.9998442
    bins = (0, 1, -1, 2, -2)
    ref, srv = _echo(rng, n)
    carry = _lsm(ref, srv, flen, fs, bins)
    got = _lsm(ref, srv, flen, fs, bins, impl=impl)
    want = np.asarray(jc.ls_filter_multiple(ref, srv, flen, fs, bins,
                                            impl=impl))
    bound = 2e-3 * np.max(np.abs(srv))
    assert np.max(np.abs(got - carry)) < bound
    assert np.max(np.abs(got - want)) < bound


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stretch", [0.9998442, 1.002, 1.024])
def test_fractional_bins_match_oracle(rng, impl, stretch):
    """Chunks off integer seconds: the order-1 ramp, the order-2 ramp and
    the direct per-bin spectra of 'carry', and the exact 'coupled' and
    'segment', all against the float64 sequential oracle: 5e-3."""
    n, flen = 4096, 16
    fs = n / stretch
    bins = (0, 1, -1, 2, -2)
    ref, srv = _echo(rng, n)
    got = _lsm(ref, srv, flen, fs, bins, impl=impl)
    want = _sequential_oracle(ref, srv, flen, fs, bins)
    assert np.max(np.abs(got - want)) < 5e-3 * np.max(np.abs(srv))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_zero_frame_guard(impl, solver):
    """All-zero frames (the pipeline's margin frames) give finite zeros in
    every impl with every solver."""
    z = np.zeros((2, 2048), np.complex64)
    out = _lsm(z, z, 16, 2048.0, (0, 1, -1), impl=impl, solver=solver)
    assert np.all(np.isfinite(out)) and np.max(np.abs(out)) == 0.0


@pytest.mark.parametrize("impl,solver", [("carry", "gs_dense"),
                                         ("coupled", "cholesky"),
                                         ("segment", "gs_matrix")])
def test_batch_equals_rows(rng, impl, solver):
    """A (B, n) call equals the per-row calls."""
    n, flen, fs, bins = 2048, 12, 2048.0 / 1.002, (0, 1, -1)
    ref = _cn(rng, 3, n)
    srv = (np.roll(ref, 1, axis=-1) + 0.1 * _cn(rng, 3, n)).astype(
        np.complex64)
    out = _lsm(ref, srv, flen, fs, bins, impl=impl, solver=solver)
    for i in range(3):
        one = _lsm(ref[i], srv[i], flen, fs, bins, impl=impl, solver=solver)
        assert np.max(np.abs(out[i] - one)) < 1e-5 * np.max(np.abs(srv[i]))


def test_unknown_impl_and_solver_raise(rng):
    ref, srv = _echo(rng, 512)
    with pytest.raises(ValueError, match="impl"):
        _lsm(ref, srv, 8, 512.0, (0,), impl="scan")
    with pytest.raises(ValueError, match="solver"):
        _lsm(ref, srv, 8, 512.0, (0,), solver="lu")


def test_ls_filter_matches_jax_and_lag_matrix(rng):
    n, flen, peek, reg = 512, 12, 4, 1.0
    ref, srv = _echo(rng, n, lag=3, noise=0.1)
    got, taps = tc.ls_filter(_t(ref), _t(srv), flen, reg=reg, peek=peek,
                             return_filter=True)
    want, jtaps = jc.ls_filter(ref, srv, flen, reg=reg, peek=peek,
                               return_filter=True)
    a = lag_matrix(ref.astype(np.complex128), flen, peek)
    ata = a.conj().T @ a
    otaps = np.linalg.solve(ata + reg * np.eye(ata.shape[0]),
                            a.conj().T @ srv.astype(np.complex128))
    bound = 2e-3 * np.max(np.abs(srv))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < bound
    assert np.max(np.abs(got.numpy() - (srv - a @ otaps))) < bound
    assert np.max(np.abs(taps.numpy() - np.asarray(jtaps))) < 2e-3


def test_ls_filter_svd_matches_jax_and_pinv(rng):
    n, flen, peek = 512, 10, 3
    ref, srv = _echo(rng, n, lag=1, noise=0.2)
    got = tc.ls_filter_svd(_t(ref), _t(srv), flen, peek=peek).numpy()
    want = np.asarray(jc.ls_filter_svd(ref, srv, flen, peek=peek))
    a = lag_matrix(ref.astype(np.complex128), flen, peek)
    u, s, vh = np.linalg.svd(a, full_matrices=False)
    sinv = np.where(s < 1e-10, 0.0, 1.0 / s)
    taps = vh.conj().T @ np.diag(sinv) @ u.conj().T @ srv.astype(
        np.complex128)
    bound = 5e-3 * np.max(np.abs(srv))
    assert np.max(np.abs(got - want)) < bound
    assert np.max(np.abs(got - (srv - a @ taps))) < bound


def test_ls_filter_toeplitz_matches_jax_and_oracle(rng):
    n, flen = 4096, 24
    ref, srv = _echo(rng, n, lag=3, noise=0.1)
    srv = (0.8 * srv).astype(np.complex64)
    got, taps = tc.ls_filter_toeplitz(_t(ref), _t(srv), flen,
                                      return_filter=True)
    want, jtaps = jc.ls_filter_toeplitz(ref, srv, flen, return_filter=True)
    oracle, otaps = toeplitz_oracle(ref, srv, flen)
    bound = 2e-3 * np.max(np.abs(srv))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < bound
    assert np.max(np.abs(got.numpy() - oracle)) < bound
    assert np.max(np.abs(taps.numpy() - otaps)) < 2e-3 * np.max(np.abs(otaps))


@pytest.mark.parametrize("assume_pd", [True, False])
def test_toeplitz_solve_matches_jax_and_scipy(rng, assume_pd):
    m = 32
    c = _cn(rng, m).astype(np.complex128)
    c[0] = np.abs(c[0]) + m          # diagonally dominant
    b = _cn(rng, 2, m).astype(np.complex128)
    got = tc.toeplitz_solve(_t(c.astype(np.complex64)),
                            _t(b.astype(np.complex64)),
                            assume_pd=assume_pd).numpy()
    for i in range(2):
        want = solve_toeplitz(c, b[i])
        jax_x = np.asarray(jc.toeplitz_solve(c.astype(np.complex64),
                                             b[i].astype(np.complex64),
                                             assume_pd=assume_pd))
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got[i] - want)) < 1e-3 * scale
        assert np.max(np.abs(got[i] - jax_x)) < 1e-4 * scale


def test_gs_dense_inverse_matches_jax_and_inverse(rng):
    m, batch = 40, 3
    cols = []
    for _ in range(batch):
        s = _cn(rng, 600).astype(np.complex128)
        cols.append(np.correlate(s, s, "full")[599:599 + m])
    c = np.stack(cols)
    x = jc.levinson_first_col(jnp.asarray(c.astype(np.complex64)))
    want = np.asarray(jc.gs_dense_inverse(x))
    got = tc.gs_dense_inverse(_t(np.array(x))).numpy()
    for i in range(batch):
        inv = np.linalg.inv(np.asarray(tc._toeplitz_matrix(
            _t(c[i])).numpy()))
        scale = np.max(np.abs(inv))
        assert np.max(np.abs(got[i] - inv)) < 2e-3 * scale
        assert np.max(np.abs(got[i] - want[i])) < 1e-4 * scale


def test_segment_geometry_matches_jax():
    for n, m in ((262144, 185), (16384, 33), (4096, 26), (2048, 22)):
        assert tc._segment_geometry(n, m) == jc._segment_geometry(n, m)


@pytest.mark.parametrize("lattice,delay", [(6, 6), (4, 8)])
def test_gal_jpe_matches_jax(rng, lattice, delay):
    """n = 400, within 1e-4 of the JAX output's peak; also the final
    reflection coefficients and taps, and a (2, n) batch against its rows."""
    n = 400
    ref = _cn(rng, 2, n)
    srv = (0.5 * np.roll(ref, 1, axis=-1) + 0.1 * _cn(rng, 2, n)).astype(
        np.complex64)
    got, k, h = tc.gal_jpe(_t(ref), _t(srv), lattice, delay, 1e-3, 1e-2,
                           return_filter=True)
    for i in range(2):
        want, jk, jh = jc.gal_jpe(ref[i], srv[i], lattice, delay, 1e-3, 1e-2,
                                  return_filter=True)
        want = np.asarray(want)
        peak = np.max(np.abs(want))
        assert np.max(np.abs(got[i].numpy() - want)) < 1e-4 * peak
        assert np.max(np.abs(k[i].numpy() - np.asarray(jk))) < 1e-4
        assert np.max(np.abs(h[i].numpy() - np.asarray(jh))) < 1e-4
    one = tc.gal_jpe(_t(ref[1]), _t(srv[1]), lattice, delay, 1e-3,
                     1e-2).numpy()
    assert np.max(np.abs(one - got[1].numpy())) < 1e-6 * np.max(np.abs(one))


def test_gal_jpe_rejects_short_delay_line(rng):
    ref, srv = _echo(rng, 64)
    with pytest.raises(ValueError, match="delay line"):
        tc.gal_jpe(_t(ref), _t(srv), 6, 4, 1e-3, 1e-2)


def test_correlation_lags_match_jax(rng):
    """linear_corr_lags (zero-padded) and circular_corr_lags against the
    JAX functions, batched rows against their single-row calls."""
    s1, s2 = _cn(rng, 2, 300), _cn(rng, 2, 300)
    lin = tc.linear_corr_lags(_t(s1), _t(s2), 40).numpy()
    circ = tc.circular_corr_lags(_t(s1), _t(s2)).numpy()
    for i in range(2):
        want_lin = np.asarray(jc.linear_corr_lags(s1[i], s2[i], 40))
        want_circ = np.asarray(jc.circular_corr_lags(s1[i], s2[i]))
        assert np.max(np.abs(lin[i] - want_lin)) < 1e-5 * np.max(
            np.abs(want_lin))
        assert np.max(np.abs(circ[i] - want_circ)) < 1e-5 * np.max(
            np.abs(want_circ))
