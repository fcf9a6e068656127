"""The port's NLMS canceller against the JAX package, on the CPU.

``passiveradar_torch.ops.clutter.nlms_filter`` is held against the JAX
``nlms_filter`` scan, and the batched plain version behind the CUDA kernel
(``ops/nlms_kernel.py``) against the JAX Pallas kernel in interpret mode, at
the shapes of tests/test_clutter.py and tests/test_nlms_pallas.py. The bound
is 1e-5 of the peak: the port and the scan differ by ~4e-7 of it (sums in
another order over thousands of dependent steps), a 25x margin.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_torch.ops import nlms_kernel as nk  # noqa: E402
from passiveradar_torch.ops.clutter import nlms_filter as t_nlms  # noqa: E402
from passiveradar_tpu.ops.clutter import nlms_filter as j_nlms  # noqa: E402
from passiveradar_tpu.ops.nlms_pallas import nlms_filter_pallas  # noqa: E402

TOL = 1e-5


def _cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inverse(gs):
    """M = (I + L)⁻¹ for L[j, i] = gs[i, j] (i < j), as the kernel forms it:
    forward substitution on the identity's columns, row i's updates of every
    later row in the order of i, the strict upper triangle dropped (under
    "nan" it may hold NaN, which the kernel never stores)."""
    t_len = gs.shape[0]
    x = np.eye(t_len, dtype=np.complex64)
    with np.errstate(invalid="ignore"):
        for i in range(t_len - 1):
            x[i + 1:] -= np.outer(gs[i, i + 1:], x[i]).astype(np.complex64)
    return np.tril(x)


def _inverse_product(mat, c):
    """e = M c as the kernel sums it: four partial sums over i mod 4, i <= j
    only (M's zero upper triangle is never multiplied)."""
    t_len = c.shape[0]
    acc = np.zeros((4, t_len), np.complex64)
    rows = np.arange(t_len)
    with np.errstate(invalid="ignore"):
        for i in range(t_len):
            acc[i % 4] = np.where(rows >= i, acc[i % 4] + mat[:, i] * c[i],
                                  acc[i % 4])
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _block_nlms(ref, srv, filter_len, mu, peek=10, block=32,
                zero_window="zero", initial_taps=None, form="solve"):
    """One frame through the kernel's block algebra, in float32 (see the
    module docstring); returns (out, taps in the reference orientation).
    ``form`` "solve" runs each block's triangular solve step by step;
    "inverse" forms M = (I + L)⁻¹ from ref alone and takes e = M c, as
    csrc/nlms.cu does."""
    ref = np.asarray(ref, np.complex64)
    srv = np.asarray(srv, np.complex64)
    n = ref.shape[0]
    if initial_taps is not None:
        w = np.flip(np.asarray(initial_taps, np.complex64)).copy()
        filter_len = w.shape[0] - peek
    m = filter_len + peek
    if initial_taps is None:
        w = np.zeros(m, np.complex64)
    steps = n - m
    mu = np.float32(mu)
    pb = min(block, m)              # segments of pb positions, q >= 1 below
    nq = m // pb
    # positions past the end read as zeros, as the kernel stages them
    padded = np.concatenate([ref, np.zeros(pb * (nq + 3) + block,
                                           np.complex64)])
    out = np.zeros(n, np.complex64)
    for k0 in range(0, steps, pb):
        t_len = min(pb, steps - k0)
        # segment k (k = 0 is the block's own) = positions
        # a + k*pb .. a + (k+1)*pb - 1; window i = [a + i, a + i + m)
        a = k0 + 1
        x = padded[a:a + pb * (nq + 2) + block]
        g = np.zeros((t_len, t_len), np.complex64)
        for lag in range(t_len):
            if lag == 0:            # |r|² alone: a zero window sums to 0
                p = (x.real * x.real + x.imag * x.imag).astype(np.complex64)
            else:
                p = np.conj(x[:-lag]) * x[lag:]
            seg = p[:pb * (nq + 2)].reshape(nq + 2, pb)
            prefix = np.concatenate([np.zeros((nq + 2, 1), np.complex64),
                                     np.cumsum(seg, axis=1)], axis=1)
            suffix = np.cumsum(seg[0, ::-1])[::-1]
            for i in range(t_len - lag):
                q, o = divmod(i + m, pb)
                middle = np.complex64(0)
                for k in range(1, q):
                    middle = middle + prefix[k, pb]
                g[i, i + lag] = (suffix[i] + middle) + prefix[q, o]
        uu = g.diagonal().real.copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            if zero_window == "zero":
                s = np.where(uu == 0, np.float32(0),
                             mu / np.maximum(uu, np.float32(1e-30)))
            else:
                s = np.where(uu == 0, np.float32(np.nan), mu / uu)
        s = s.astype(np.float32)
        gs = np.triu(s[:, None] * g, 1)
        u = ref[a + np.arange(t_len)[:, None] + np.arange(m)]   # (T, m)
        e = srv[k0 + filter_len:k0 + filter_len + t_len] - u @ np.conj(w)
        if form == "inverse":
            e = _inverse_product(_inverse(gs), e)
        else:
            for i in range(t_len - 1):
                e[i + 1:] -= e[i] * gs[i, i + 1:]
        out[filter_len + k0:filter_len + k0 + t_len] = e
        q = (s * np.conj(e)).astype(np.complex64)
        w = w + (q[:, None] * u).sum(0, dtype=np.complex64)
    return out, np.flip(w)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def _assert_same_nans(got, want):
    """Equal NaN masks, the finite parts within the bound."""
    got, want = np.asarray(got), np.asarray(want)
    mask = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), mask)
    if mask.all():
        return
    assert np.all(np.isfinite(got[~mask]))
    assert np.max(np.abs(got[~mask] - want[~mask])) <= \
        TOL * np.max(np.abs(want[~mask]))


@pytest.mark.parametrize("n,flen,mu,peek", [(600, 12, 0.05, 10),
                                            (20000, 8, 0.1, 2),
                                            (700, 12, 0.05, 4)])
def test_nlms_filter_matches_scan(rng, n, flen, mu, peek):
    ref = _cnoise(rng, n)
    srv = (0.5 * np.roll(ref, 2) + 0.1 * _cnoise(rng, n)).astype(np.complex64)
    want, wtaps = j_nlms(ref, srv, flen, mu, peek=peek, return_filter=True)
    got, gtaps = t_nlms(_t(ref), _t(srv), flen, mu, peek=peek,
                        return_filter=True)
    _assert_close(got.numpy(), want)
    _assert_close(gtaps.numpy(), wtaps)


def test_nlms_filter_warm_start_matches_scan(rng):
    """The scan's warm start: taps of a first pass fed back as
    initial_taps, the filter length taken from their length."""
    n, flen, mu, peek = 400, 6, 0.05, 3
    ref, srv = _cnoise(rng, n), _cnoise(rng, n)
    _, taps = j_nlms(ref, srv, flen, mu, peek=peek, return_filter=True)
    taps = np.asarray(taps)
    want = j_nlms(ref, srv, flen, mu, peek=peek, initial_taps=taps)
    got = t_nlms(_t(ref), _t(srv), 99, mu, peek=peek,
                 initial_taps=_t(taps))
    assert got.shape == (n,)
    _assert_close(got.numpy(), want)


def test_nlms_filter_zero_window_nan_like_scan(rng):
    """An all-zero window divides 0/0 in the scan: NaN from the next step
    on. The port reproduces the mask exactly."""
    n, flen, mu = 600, 8, 0.1
    ref = _cnoise(rng, n)
    ref[300:400] = 0
    srv = (0.5 * np.roll(ref, 1) + 0.01 * _cnoise(rng, n)).astype(np.complex64)
    want = np.asarray(j_nlms(ref, srv, flen, mu))
    got = t_nlms(_t(ref), _t(srv), flen, mu).numpy()
    assert np.isnan(want).sum() > 0 and np.isfinite(want[:300]).all()
    _assert_same_nans(got, want)


def test_nlms_filter_rejects_batches(rng):
    x = _t(_cnoise(rng, (2, 64)))
    with pytest.raises(ValueError, match="1-D"):
        t_nlms(x, x, 8, 0.1)


def test_batch_plain_matches_pallas_single(rng):
    n, flen, mu, peek = 700, 12, 0.05, 4
    ref = _cnoise(rng, n)
    srv = (0.5 * np.roll(ref, 2) + 0.1 * _cnoise(rng, n)).astype(np.complex64)
    want, wtaps = nlms_filter_pallas(ref, srv, flen, mu, peek=peek, block=256,
                                     return_filter=True, interpret=True)
    got, gtaps = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu,
                                            peek=peek, return_filter=True)
    _assert_close(got.numpy(), want)
    _assert_close(gtaps.numpy(), wtaps)


def test_batch_plain_matches_pallas_batched(rng):
    b, n, flen, mu = 3, 520, 8, 0.08
    ref = _cnoise(rng, (b, n))
    srv = (0.7 * np.roll(ref, 1, axis=1)
           + 0.05 * _cnoise(rng, (b, n))).astype(np.complex64)
    want, wtaps = nlms_filter_pallas(ref, srv, flen, mu, block=256,
                                     return_filter=True, interpret=True)
    got, gtaps = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu,
                                            return_filter=True)
    assert got.shape == (b, n) and gtaps.shape == (b, flen + 10)
    for i in range(b):
        _assert_close(got[i].numpy(), np.asarray(want)[i])
        _assert_close(gtaps[i].numpy(), np.asarray(wtaps)[i])


def test_batch_plain_zero_window_finite_like_pallas(rng):
    """zero_window='zero' is the Pallas guard max(uᴴu, 1e-30): zero windows
    leave the taps alone, the output stays finite and equal to the
    kernel's."""
    n, flen, mu = 600, 8, 0.1
    ref = _cnoise(rng, n)
    ref[:200] = 0
    srv = (0.5 * np.roll(ref, 1) + 0.01 * _cnoise(rng, n)).astype(np.complex64)
    want = np.asarray(nlms_filter_pallas(ref, srv, flen, mu, block=256,
                                         interpret=True))
    got = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu).numpy()
    assert np.all(np.isfinite(got))
    _assert_close(got, want)


def test_batch_nan_and_zero_windows_per_frame(rng):
    """One frame with a zero run longer than m among finite frames: under
    'nan' only that frame turns NaN (from the step after its first zero
    window), as the vmapped scan gives; under 'zero' all stay finite."""
    b, n, flen, mu, peek = 3, 900, 10, 0.05, 10
    ref = _cnoise(rng, (b, n))
    ref[1, 300:360] = 0
    srv = (0.5 * np.roll(ref, 2, axis=1)
           + 0.1 * _cnoise(rng, (b, n))).astype(np.complex64)
    want = np.stack([np.asarray(j_nlms(ref[i], srv[i], flen, mu, peek=peek))
                     for i in range(b)])
    got = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu, peek=peek,
                                     zero_window="nan").numpy()
    assert np.isnan(want[1]).any() and not np.isnan(want[[0, 2]]).any()
    _assert_same_nans(got, want)
    guarded = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu,
                                         peek=peek).numpy()
    assert np.all(np.isfinite(guarded))
    _assert_close(guarded[[0, 2]], want[[0, 2]])


def test_taps_carried_from_jax_to_port(rng):
    """JAX taps (reference orientation, complex64 numpy) as the port's
    initial_taps give the JAX warm-started outputs and taps."""
    n, flen, mu, peek = 500, 10, 0.05, 4
    ref = _cnoise(rng, n)
    srv = (0.6 * np.roll(ref, 3) + 0.1 * _cnoise(rng, n)).astype(np.complex64)
    _, jtaps = j_nlms(ref[:250], srv[:250], flen, mu, peek=peek,
                      return_filter=True)
    jtaps = np.asarray(jtaps)
    want, wtaps = j_nlms(ref, srv, flen, mu, peek=peek, initial_taps=jtaps,
                         return_filter=True)
    got, gtaps = nk.nlms_filter_batch(_t(ref), _t(srv), flen, mu, peek=peek,
                                      initial_taps=jtaps, return_filter=True,
                                      zero_window="nan")
    _assert_close(got.numpy(), want)
    _assert_close(gtaps.numpy(), wtaps)


def test_taps_carried_from_port_to_jax(rng):
    """The port's taps, as numpy, warm-start the JAX scan and the JAX
    Pallas kernel's semantics the same way they warm-start the port."""
    n, flen, mu, peek = 500, 10, 0.05, 4
    ref = _cnoise(rng, (2, n))
    srv = (0.6 * np.roll(ref, 3, axis=1)
           + 0.1 * _cnoise(rng, (2, n))).astype(np.complex64)
    _, ptaps = nk.nlms_filter_batch(_t(ref[:, :250]), _t(srv[:, :250]), flen,
                                    mu, peek=peek, return_filter=True)
    assert ptaps.shape == (2, flen + peek)
    got = nk.nlms_filter_batch(_t(ref), _t(srv), flen, mu, peek=peek,
                               initial_taps=ptaps).numpy()
    for i in range(2):
        taps_np = ptaps[i].numpy()
        assert taps_np.dtype == np.complex64
        want = np.asarray(j_nlms(ref[i], srv[i], flen, mu, peek=peek,
                                 initial_taps=taps_np))
        _assert_close(got[i], want)


def test_wrapper_takes_plain_version_on_cpu(rng):
    b, n, flen, mu = 2, 300, 6, 0.05
    ref, srv = _t(_cnoise(rng, (b, n))), _t(_cnoise(rng, (b, n)))
    before = nk.nlms_filter_batch.launches
    for zw in nk.ZERO_WINDOWS:
        got = nk.nlms_filter_batch(ref, srv, flen, mu, zero_window=zw)
        want = nk.nlms_filter_batch_plain(ref, srv, flen, mu, zero_window=zw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert nk.nlms_filter_batch.launches == before
    one = nk.nlms_filter_batch(ref[1], srv[1], flen, mu)
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(zero_window="clip"), "zero_window"),
    (dict(filter_len=300), "n > filter_len"),
    (dict(filter_len=0), "filter_len >= 1"),
    (dict(initial_taps=np.zeros((3, 12), np.complex64)), "initial_taps"),
])
def test_batch_rejects_bad_arguments(rng, kwargs, match):
    x = _t(_cnoise(rng, (2, 300)))
    args = dict(filter_len=8, mu=0.05)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        nk.nlms_filter_batch(x, x, **args)


def _zero_run(ref, start, length, tiny=None):
    """ref with a zero run: the first all-zero window is step start - 1.
    With ``tiny`` the first sample after the run is scaled by it, so the
    windows at the run's far edge hold one small sample and take large
    steps."""
    ref = ref.copy()
    ref[start:start + length] = 0
    if tiny is not None:
        ref[start + length] *= tiny
    return ref


@pytest.mark.parametrize("form", ["solve", "inverse"])
@pytest.mark.parametrize("n,flen,peek,zero_at,zero_window,tiny", [
    (1000, 23, 10, None, "zero", None),  # m = 33; 967 steps = 30 blocks + 7
    (3000, 175, 10, None, "nan", None),  # m = 185, the FM taps; ragged tail
    (1500, 23, 10, 32 * 20 + 1, "zero", None),  # zero run from a block's edge
    (1500, 23, 10, 32 * 20 + 1, "nan", None),
    (1500, 23, 10, 32 * 20 + 14, "zero", None),  # zero run from mid-block
    (1500, 23, 10, 32 * 20 + 14, "nan", None),
    (4000, 175, 10, 32 * 60 + 1, "nan", None),
    (4000, 175, 10, 32 * 60 + 19, "zero", None),
    # m = 1: blocks of pb = min(P, m) = 1 step, Q = 1
    (600, 1, 0, None, "zero", None),
    # a 1e-4 sample right after the zero run: s_i ~ 1e8 at its far edge
    (6000, 175, 10, 32 * 60 + 19, "zero", 1e-4),
    (6000, 175, 10, 32 * 60 + 19, "nan", 1e-4),
])
def test_block_model_matches_scan_and_plain(rng, n, flen, peek, zero_at,
                                            zero_window, tiny, form):
    """The kernel's block algebra, by the step-by-step solve and by the
    inverse M = (I + L)⁻¹, against the JAX scan and the port's plain
    version: within TOL with equal NaN masks. Under 'zero' a zero run
    leaves the taps alone and the scan's NaN does not apply, so there the
    scan is held only up to the first zero window."""
    ref = _cnoise(rng, n)
    m = flen + peek
    if zero_at is not None:
        ref = _zero_run(ref, zero_at, m + 60, tiny)
    srv = (0.5 * np.roll(ref, 3) + 0.01 * np.flip(ref)
           + 0.1 * _cnoise(rng, n)).astype(np.complex64)
    mu = 0.05
    got, gtaps = _block_nlms(ref, srv, flen, mu, peek=peek,
                             zero_window=zero_window, form=form)
    want, wtaps = nk.nlms_filter_batch_plain(_t(ref), _t(srv), flen, mu,
                                             peek=peek, return_filter=True,
                                             zero_window=zero_window)
    _assert_same_nans(got, want.numpy())
    if zero_window == "nan" or zero_at is None:
        _assert_same_nans(gtaps, wtaps.numpy())
    jw = np.asarray(j_nlms(ref, srv, flen, mu, peek=peek))
    if zero_window == "nan" or zero_at is None:
        _assert_same_nans(got, jw)
    else:
        first = flen + zero_at - 1            # output of the first zero window
        assert np.isnan(jw[first + 1:n - peek]).all()
        assert np.isfinite(got).all()
        _assert_same_nans(got[:first + 1], jw[:first + 1])
        _assert_close(gtaps, wtaps.numpy())
    if zero_at is not None and zero_window == "nan":
        first = flen + zero_at - 1
        assert np.isfinite(got[:first + 1]).all()
        assert np.isnan(got[first + 1:n - peek]).all()


def test_block_model_warm_start_matches_scan_and_plain(rng):
    """The warm start with return_filter: taps of a first pass fed back as
    initial_taps, through the block algebra, the scan and the plain
    version."""
    n, flen, peek, mu = 2500, 175, 10, 0.05
    ref = _cnoise(rng, n)
    srv = (0.6 * np.roll(ref, 5) + 0.1 * _cnoise(rng, n)).astype(np.complex64)
    _, taps = j_nlms(ref[:1200], srv[:1200], flen, mu, peek=peek,
                     return_filter=True)
    taps = np.asarray(taps)
    got, gtaps = _block_nlms(ref, srv, 0, mu, peek=peek, initial_taps=taps)
    want, wtaps = j_nlms(ref, srv, flen, mu, peek=peek, initial_taps=taps,
                         return_filter=True)
    _assert_close(got, want)
    _assert_close(gtaps, wtaps)
    pw, ptaps = nk.nlms_filter_batch_plain(_t(ref), _t(srv), 0, mu, peek=peek,
                                           initial_taps=_t(taps),
                                           return_filter=True)
    _assert_close(got, pw.numpy())
    _assert_close(gtaps, ptaps.numpy())


def test_block_gram_sums_only_window_terms(rng):
    """At the edge of a zero run a window holds a few samples; its Gram
    entries, summed as suffix + whole segments + prefix, keep their error
    relative to |u_i||u_j| (float64 direct sums as the truth)."""
    m, pb = 33, 32
    ref = _cnoise(rng, 200)
    ref[40:] = 0
    ref[39] *= 1e-3                 # the last window before the run: tiny
    a = 10                          # windows 29..31 hold one or no sample
    x = ref[a:a + 3 * pb + pb]
    x64 = x.astype(np.complex128)
    for lag in range(1, pb):
        p = np.conj(x[:-lag]) * x[lag:]
        seg = p[:3 * pb].reshape(3, pb)
        prefix = np.concatenate([np.zeros((3, 1), np.complex64),
                                 np.cumsum(seg, axis=1)], axis=1)
        suffix = np.cumsum(seg[0, ::-1])[::-1]
        for i in range(pb - lag):
            q, o = divmod(i + m, pb)
            middle = sum(prefix[k, pb] for k in range(1, q))
            got = (suffix[i] + middle) + prefix[q, o]
            exact = np.vdot(x64[i:i + m], x64[i + lag:i + lag + m])
            scale = (np.linalg.norm(x64[i:i + m])
                     * np.linalg.norm(x64[i + lag:i + lag + m]))
            assert abs(got - exact) <= 1e-5 * scale
