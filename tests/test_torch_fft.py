"""The port's fused four-step FFT (B3) and its FFT routing against the JAX
package, on the CPU.

The JAX fused kernel runs in interpret mode (``PASSIVERADAR_PALLAS_FFT=1``
set through monkeypatch, as tests/test_mxufft.py runs it). Tolerances are
test_mxufft.py's: atol 2e-5·√n forward (the output's rms is √n for unit
inputs) and 2e-5 inverse; the LS canceller through the fused route within
atol 2e-4 of the JAX default route, the bound of test_mxufft.py:99.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.ops import fft_pallas  # noqa: E402
from passiveradar_tpu.ops.clutter import \
    ls_filter_multiple as j_ls  # noqa: E402
from passiveradar_torch.ops import fft as tfft  # noqa: E402
from passiveradar_torch.ops import fft_kernel as fk  # noqa: E402
from passiveradar_torch.ops.clutter import \
    ls_filter_multiple as t_ls  # noqa: E402

SIZES = [16384, 32768, 65536]


def _rand_c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _tol(n, inverse):
    return 2e-5 if inverse else 2e-5 * np.sqrt(n)


@pytest.fixture(scope="module")
def jax_fused():
    """{(n, inverse): (x, JAX fft_fused(x), jnp.fft(x))} at batch 3, the
    JAX kernel in interpret mode, computed once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    out = {}
    try:
        for n in SIZES:
            x = _rand_c((3, n), seed=n + 7)
            for inverse in (False, True):
                got = np.asarray(fft_pallas.fft_fused(jnp.asarray(x),
                                                      inverse=inverse))
                ref = np.asarray((jnp.fft.ifft if inverse else jnp.fft.fft)(x))
                out[(n, inverse)] = (x, got, ref)
    finally:
        mp.undo()
    return out


def test_split_table_matches_jax():
    assert fk._SPLITS == fft_pallas._SPLITS
    for n in (8192, 16384, 262144, 524288):
        assert fk.supported(n) == fft_pallas.supported(n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16384, 262144])
def test_tables_match_jax(n, inverse):
    """The float64 reduced-angle tables, re-derived, equal the JAX
    package's float32 planes bit for bit."""
    dr, dc, tw = fk._tables(n, inverse)
    jdr_r, jdr_i, jdc_r, jdc_i, jtw_r, jtw_i = fft_pallas._tables(n, inverse)
    for got, re, im in ((dr, jdr_r, jdr_i), (dc, jdc_r, jdc_i),
                        (tw, jtw_r, jtw_i)):
        np.testing.assert_array_equal(got.real, re)
        np.testing.assert_array_equal(got.imag, im)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", sorted(fk._SPLITS))
def test_kernel_tables_match_float64(n, inverse):
    """The kernel's stage twiddles for R and C against the float64
    exponentials and against the planes of _tables: within 2 float32 ulps.
    The kernel runs the inverse as conj ∘ forward ∘ conj, so its tables
    are the conjugates of the inverse planes (D_C also without its 1/n)."""
    dr, dc, _ = fk._tables(n, inverse)
    for length, got, plane in zip(fk._SPLITS[n],
                                  fk._kernel_tables(n, torch.device("cpu")),
                                  (dr, dc * np.float32(n) if inverse else dc)):
        got = got.numpy()
        assert got.dtype == np.complex64
        assert got.shape == (56 + (length // 64 - 1) * 64,)
        r, k = np.meshgrid(np.arange(1, 8), np.arange(8), indexing="ij")
        rb, b = np.meshgrid(np.arange(1, length // 64), np.arange(64),
                            indexing="ij")
        # exponents over `length`: W_64^(r·k) = W_L^(r·k·L/64), W_L^(r·b)
        e = np.concatenate([(r * k * (length // 64)).ravel(),
                            (rb * b).ravel()])
        exact = np.exp(-2j * np.pi * e / length)
        fwd = np.conj(plane[1, e % length]) if inverse else plane[1, e % length]
        for want in (exact.astype(np.complex64), fwd):
            np.testing.assert_array_max_ulp(got.real, want.real, maxulp=2)
            np.testing.assert_array_max_ulp(got.imag, want.imag, maxulp=2)
        assert np.abs(got - exact).max() <= 2 * 2.0 ** -24


@pytest.mark.parametrize("length", [128, 256, 512])
def test_stage_twiddles_give_the_dft(length):
    """The kernel's three Stockham stages (radix 8, 8, length/64; Ns = 1,
    8, 64), in numpy with its tables and its read, twiddle and write
    indices, give the DFT: the arithmetic the CUDA kernel's threads run,
    held against numpy's FFT."""
    tw = fk._stage_twiddles(length).astype(np.complex128)
    x = _rand_c((2, length), seed=length).astype(np.complex128)
    a = x
    for ns, radix, off in ((1, 8, None), (8, 8, 0), (64, length // 64, 56)):
        nb = length // radix                    # butterflies
        j = np.arange(nb)
        k = j % ns
        r = np.arange(radix)[:, None]
        v = a[:, j[None, :] + nb * r]           # (batch, radix, nb)
        if off is not None:                     # W_{ns·radix}^(r·k), r ≥ 1
            w = np.ones((radix, nb), dtype=complex)
            w[1:] = tw[off + (r[1:] - 1) * ns + k[None, :]]
            v = v * w
        v = np.fft.fft(v, axis=1)
        out = np.empty_like(a)
        out[:, (j // ns)[None, :] * ns * radix + k[None, :] + ns * r] = v
        a = out
    np.testing.assert_allclose(a, np.fft.fft(x), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fn", ["reference", "wrapper"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_fft_fused_matches_jax(jax_fused, n, inverse, fn):
    """fft_fused_reference and fft_fused (a CPU tensor takes the plain
    version) against the JAX fused kernel and jnp.fft."""
    x, want_fused, want_fft = jax_fused[(n, inverse)]
    f = fk.fft_fused_reference if fn == "reference" else fk.fft_fused
    got = f(torch.from_numpy(x), inverse=inverse)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    tol = _tol(n, inverse)
    np.testing.assert_allclose(got.numpy(), want_fused, atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_fft, atol=tol, rtol=0)


def test_fft_fused_leading_dims_and_real_input(jax_fused):
    n = 16384
    x, want, _ = jax_fused[(n, False)]
    got = fk.fft_fused(torch.from_numpy(x.reshape(3, 1, n)))
    assert got.shape == (3, 1, n)
    np.testing.assert_allclose(got[:, 0].numpy(), want, atol=_tol(n, False),
                               rtol=0)
    xr = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    got = fk.fft_fused(torch.from_numpy(xr))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.fft.fft(xr),
                               atol=_tol(n, False), rtol=0)


@pytest.mark.parametrize("n", [8192, 524288, 20000])
def test_fft_fused_rejects_unsupported_length(n):
    with pytest.raises(ValueError, match="unsupported length"):
        fk.fft_fused(torch.zeros((1, n), dtype=torch.complex64))
    with pytest.raises(ValueError, match="unsupported length"):
        fk.fft_fused_reference(torch.zeros((1, n), dtype=torch.complex64))


@pytest.mark.parametrize("env,on", [(None, False), ("0", False), ("", False),
                                    ("false", False), ("1", True),
                                    ("yes", True)])
def test_use_fused_reads_env_at_call_time(monkeypatch, env, on):
    monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)
    if env is not None:
        monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", env)
    assert fk.use_fused() is on
    assert fft_pallas.use_fused() is on


@pytest.mark.parametrize("env", [True, False])
@pytest.mark.parametrize("n", [8192, 65536, 524288])
def test_fft_auto_route(monkeypatch, n, env):
    """Under the env, fft_auto / ifft_auto reach fft_fused at 65,536 only:
    8,192 is below AUTO_MIN and 2^19 is not in the split table. Without
    it they never do. The result is the DFT either way."""
    monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)
    if env:
        monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    calls = []
    real = fk.fft_fused

    def spy(x, inverse=False):
        calls.append((tuple(x.shape), inverse))
        return real(x, inverse)

    monkeypatch.setattr(fk, "fft_fused", spy)
    x = _rand_c((1, n), seed=3)
    fwd = tfft.fft_auto(torch.from_numpy(x))
    inv = tfft.ifft_auto(torch.from_numpy(x))
    routed = env and n == 65536
    assert calls == ([((1, n), False), ((1, n), True)] if routed else [])
    np.testing.assert_allclose(fwd.numpy(), np.fft.fft(x),
                               atol=_tol(n, False), rtol=0)
    np.testing.assert_allclose(inv.numpy(), np.fft.ifft(x),
                               atol=_tol(n, True), rtol=0)


def test_fft_auto_pads_and_other_dims(monkeypatch):
    """Padding to n, truncation and a non-last dim through the fused
    route."""
    monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    x = _rand_c((40000, 2), seed=5)
    got = tfft.fft_auto(torch.from_numpy(x), n=65536, dim=0)
    want = np.fft.fft(x, n=65536, axis=0)
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(65536, False),
                               rtol=0)
    y = _rand_c((2, 70000), seed=6)
    got = tfft.ifft_auto(torch.from_numpy(y), n=65536)
    np.testing.assert_allclose(got.numpy(), np.fft.ifft(y[:, :65536]),
                               atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.fft(torch.zeros(12, dtype=torch.complex64))


def test_ls_filter_multiple_fused_route_matches_jax(monkeypatch):
    """The LS canceller at n = 65,536 with the port's fused route on
    (its batched forward transform and its final inverse take fft_fused:
    two calls) against the JAX package's default route."""
    n = 65536
    rng = np.random.default_rng(5)
    ref = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64)
    srv = (0.3 * np.roll(ref, 7) + 0.1 * rng.standard_normal(n)
           ).astype(np.complex64)
    bins = (0.0, 1.0, -1.0, 2.0, -2.0)
    want = np.asarray(j_ls(jnp.asarray(ref), jnp.asarray(srv), 22,
                           float(n), bins))
    calls = []
    real = fk.fft_fused

    def spy(x, inverse=False):
        calls.append((tuple(x.shape), inverse))
        return real(x, inverse)

    monkeypatch.setattr(fk, "fft_fused", spy)
    monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    got = t_ls(torch.from_numpy(ref), torch.from_numpy(srv), 22, float(n),
               bins)
    assert calls == [((1, 3, n), False), ((1, n), True)]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
