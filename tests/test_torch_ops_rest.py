"""The port's small ingest utilities against the JAX package, on the CPU:
``deinterleave_iq`` (with the reference's odd-length quirk), ``normalize``,
``shift``, ``offset_compensation`` and ``channel_preprocessing``, and the
device policy of every function added beside them.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.ops import util as jutil  # noqa: E402
from passiveradar_tpu.ops.xcorr import \
    channel_preprocessing as j_chan_pre  # noqa: E402
from passiveradar_tpu.ops.xcorr import \
    offset_compensation as j_offset_comp  # noqa: E402
from passiveradar_torch import ops as tops  # noqa: E402
from passiveradar_torch.ops import util as tutil  # noqa: E402
from passiveradar_torch.ops.xcorr import \
    channel_preprocessing as t_chan_pre  # noqa: E402
from passiveradar_torch.ops.xcorr import \
    offset_compensation as t_offset_comp  # noqa: E402


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,dtype", [(20, np.int16), (21, np.int16),
                                     (1, np.float32), (4097, np.float32)])
def test_deinterleave_iq_matches_jax(rng, n, dtype):
    """Even and odd lengths: [0:-1:2] drops an odd input's final I sample
    (docs/PARITY.md, row deinterleave_IQ)."""
    x = (1000 * rng.standard_normal(n)).astype(dtype)
    want = np.asarray(jutil.deinterleave_iq(x))
    got = tutil.deinterleave_iq(_t(x)).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape == (
        (n - 1) // 2 if n % 2 else n // 2,)
    np.testing.assert_array_equal(got, want)


def test_normalize_matches_jax(rng):
    x = _cn(rng, 1000) * 7.5
    want = np.asarray(jutil.normalize(x))
    got = tutil.normalize(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert abs(np.mean(np.abs(got)) - 1.0) < 1e-5


@pytest.mark.parametrize("k", [0, 5, -7, 99])
def test_shift_matches_jax(rng, k):
    x = _cn(rng, 100)
    np.testing.assert_array_equal(tutil.shift(_t(x), k).numpy(),
                                  np.asarray(jutil.shift(x, k)))


@pytest.mark.parametrize("offset", [37, -12, 0])
def test_offset_compensation_matches_jax(rng, offset):
    """A channel delayed by ``offset`` samples comes back aligned, as the
    JAX function returns it."""
    n = 8192
    base = _cn(rng, n + 100)
    x1 = base[50:50 + n]
    x2 = base[50 - offset:50 - offset + n]
    want = np.asarray(j_offset_comp(x1, x2, 4096, 1, 64))
    got = t_offset_comp(_t(x1), _t(x2), 4096, 1, 64).numpy()
    np.testing.assert_array_equal(got, want)


def test_channel_preprocessing_matches_jax(rng):
    raw = (3000 * rng.standard_normal(2 * 6000)).astype(np.int16)
    want = np.asarray(j_chan_pre(raw, 4, -1500.0, 48000.0))
    got = t_chan_pre(_t(raw), 4, -1500.0, 48000.0).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))


_NUMPY_CALLS = {
    "ls_filter": lambda z, **kw: tops.ls_filter(z, z, 4, **kw),
    "ls_filter_svd": lambda z, **kw: tops.ls_filter_svd(z, z, 4, **kw),
    "ls_filter_toeplitz": lambda z, **kw: tops.ls_filter_toeplitz(z, z, 4,
                                                                  **kw),
    "ls_filter_multiple": lambda z, **kw: tops.ls_filter_multiple(
        z, z, 4, 64.0, **kw),
    "gal_jpe": lambda z, **kw: tops.gal_jpe(z, z, 2, 2, 1e-3, 1e-2, **kw),
    "toeplitz_solve": lambda z, **kw: tops.toeplitz_solve(z[:4], z[:4],
                                                          **kw),
    "direct_xambg": lambda z, **kw: tops.direct_xambg(z, z, 2, 4, 64.0, **kw),
    "decimate_taps": lambda z, **kw: tops.decimate_taps(z, np.ones(3), 2,
                                                        **kw),
    "mix_resample_poly": lambda z, **kw: tops.mix_resample_poly(
        z, 1.0, 64.0, 0.0, 1, 2, **kw),
    "deinterleave_iq": lambda z, **kw: tops.deinterleave_iq(z.real, **kw),
    "normalize": lambda z, **kw: tops.normalize(z, **kw),
    "shift": lambda z, **kw: tops.shift(z, 1, **kw),
    "offset_compensation": lambda z, **kw: tops.offset_compensation(
        z, z, 32, 1, 4, **kw),
    "channel_preprocessing": lambda z, **kw: tops.channel_preprocessing(
        z.real, 2, 1.0, 64.0, **kw),
}


@pytest.mark.parametrize("name", sorted(_NUMPY_CALLS))
def test_numpy_input_defaults_to_the_card(name):
    """Numpy input goes to the CUDA card by default, and raises where there
    is none; device='cpu' runs it on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    z = (np.arange(64) % 7 + 1j * (np.arange(64) % 5)).astype(np.complex64)
    with pytest.raises(RuntimeError, match="CUDA"):
        _NUMPY_CALLS[name](z)
    out = _NUMPY_CALLS[name](z, device="cpu")
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "cpu"
