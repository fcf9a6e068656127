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
