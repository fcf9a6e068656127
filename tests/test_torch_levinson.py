"""The Levinson kernel's plain version and the graphed LS stage, on the CPU.

* ``ops/levinson_kernel.levinson_first_col_plain`` against the JAX
  package's ``levinson_first_col`` at the FM width (50 systems of m = 185),
  on a guarded all-zero system and at m ∈ {1, 2, 33, 210};
* a numpy transcription of the kernel's Schur–Levinson step
  (``csrc/levinson.cu``) in complex64 against the plain loop, and no
  farther than LEVINSON_VS_F64 times the plain loop from the complex128
  recursion, on the same systems;
* (marked ``cuda``, on the card) the kernel at every register-variant
  boundary against the plain loop and the complex128 recursion;
* the wrapper's refusals, made before any library load;
* the constant tables of the LS stage, now made once per device and
  shape, bit-equal to the per-call tables they replace;
* ``ops/clutter.ls_filter_multiple_graphed`` on CPU tensors, bit-equal to
  the eager stage (its key: tests/test_torch_graphs.py);
* the LS stage as the pipeline calls it against the JAX package's.

JAX is imported inside the tests that compare with it, so that the file
also collects where JAX is absent (the card's host, ``-m cuda``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_torch.ops import clutter as tc  # noqa: E402
from passiveradar_torch.ops import graphs  # noqa: E402
from passiveradar_torch.ops import levinson_kernel as lk  # noqa: E402
from passiveradar_torch.ops import mixer as tmixer  # noqa: E402

TOL = 1e-4           # tests/test_torch_ops.py's Levinson bound
# a float32 recursion's distance from the complex128 one, over the plain
# float32 loop's (chip_smoke.py LEVINSON_VS_F64)
LEVINSON_VS_F64 = 2.0
BINS = (0, 1, -1, 2, -2)
# tests/test_torch_pipeline.py's TINY geometry: 16,384-sample CPIs
TINY = dict(
    input_file="", input_ref_path="/data/ref", input_srv_path="/data/srv",
    range_doppler_map_ftype="hdf5", output_fname="tiny_maps", num_frames=8,
    input_sample_rate=49152, input_center_freq=1_000_000,
    channel_freq=990_170, channel_bandwidth=12800, cpi_seconds_nominal=1.0,
    max_doppler_nominal=128.0, max_range_nominal=400.0, overlap_cpi=True,
    frame_batch=4)


def _jax_levinson(c: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from passiveradar_tpu.ops import clutter as jc
    return np.asarray(jc.levinson_first_col(jnp.asarray(c)))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _echo_autocorr(rng, systems: int, m: int, n: int = 4096) -> np.ndarray:
    """(systems, m) complex64 first columns: autocorrelation lags 0..m−1 of
    noise plus a delayed, scaled copy of itself (a direct path and an
    echo), one draw a system."""
    out = np.empty((systems, m), np.complex64)
    for b in range(systems):
        s = _cn(rng, n).astype(np.complex128)
        s = s + 0.5 * np.roll(s, 1 + b % 40)
        spec = np.fft.fft(s, 2 * n)
        out[b] = np.fft.ifft(spec * spec.conj())[:m]
    return out


def _per_system_rel(got, want):
    """Largest distance of one system's x from the reference, over that
    system's peak |x| (chip_smoke.py per_system_rel)."""
    w = np.maximum(np.abs(want).max(-1), 1e-30)
    return float((np.abs(got - want).max(-1) / w).max())


def _schur_levinson(c: np.ndarray) -> np.ndarray:
    """csrc/levinson.cu's recursion in numpy complex64, over a batch: X
    holds a below the step k and the residual u = a∗c from k on, Y (at the
    offset m − k) holds ar below k and v = ar∗c from k on; each step forms
    the next κ from u[k+1] and v[k+1] alone, as −u·(1/e) (the kernel takes
    the reciprocal approximately), then updates every entry the same way,
    the pivot's X becoming κ."""
    c = np.ascontiguousarray(c, np.complex64)
    b, m = c.shape
    one = np.float32(1)
    x = c.copy()
    x[:, 0] = 1
    y = np.zeros((b, 2 * m - 1), np.complex64)
    y[:, m:] = c[:, :m - 1]
    e = c[:, 0].real.copy()
    kap = np.zeros(b, np.complex64)
    if m > 1:
        kap = (-x[:, 1] * (one / e)).astype(np.complex64)
    j = np.arange(m)
    for k in range(1, m):
        e_next = e * (one - (kap.real * kap.real + kap.imag * kap.imag))
        kap_next = kap
        if k + 1 < m:
            u = x[:, k + 1] + kap * y[:, m + 1]
            kap_next = (-u * (one / e_next)).astype(np.complex64)
        yk = y[:, j + m - k]
        x, y[:, j + m - k] = x + kap[:, None] * yk, \
            yk + kap.conj()[:, None] * x
        x[:, k] = kap
        e, kap = e_next, kap_next
    return x / e[:, None]


def _levinson_cases():
    """(name, (B, m) complex64 systems): the FM width, the guarded zero
    system in a batch of live ones (as a margin frame's bins sit among the
    stage's systems), and m ∈ {1, 2, 33, 210}."""
    rng = np.random.default_rng(15)
    zero = tc._guard(torch.from_numpy(np.concatenate([
        np.zeros((1, 64), np.complex64), _echo_autocorr(rng, 6, 64)]))
    ).numpy()
    cases = [("fm", _echo_autocorr(np.random.default_rng(14), 50, 185)),
             ("guarded_zero", zero)]
    cases += [(f"m{m}", _echo_autocorr(np.random.default_rng(100 + m), 6, m))
              for m in (1, 2, 33, 210)]
    return cases


@pytest.mark.parametrize("name,c", _levinson_cases(),
                         ids=[n for n, _ in _levinson_cases()])
def test_schur_levinson_transcription_matches_plain(name, c):
    """The kernel's recursion, transcribed: within TOL of the plain loop,
    and no farther than LEVINSON_VS_F64 times the plain loop from the
    complex128 recursion (the chip's gate); the guarded zero system's x is
    e₀/1e-25, as the plain loop's."""
    got = _schur_levinson(c)
    plain = lk.levinson_first_col_plain(torch.from_numpy(c)).numpy()
    f64 = lk.levinson_first_col_plain(torch.from_numpy(
        c.astype(np.complex128))).numpy()
    assert np.all(np.isfinite(got))
    assert _per_system_rel(got, plain) < TOL
    assert _per_system_rel(got, f64) <= \
        LEVINSON_VS_F64 * _per_system_rel(plain, f64)
    if name == "guarded_zero":
        np.testing.assert_array_equal(got[0], plain[0])


def test_levinson_plain_matches_jax_at_fm_width():
    """50 systems of m = 185 (10 frames × 5 bins at FM)."""
    c = _echo_autocorr(np.random.default_rng(14), 50, 185)
    got = lk.levinson_first_col_plain(torch.from_numpy(c)).numpy()
    assert got.shape == (50, 185)
    assert _rel(got, _jax_levinson(c)) < TOL


def test_levinson_guarded_zero_system_stays_finite():
    """An all-zero frame's system after the stage's guard (c[0] = 1e-25,
    δ = 1e25): finite, x = e₀/1e-25, beside a live system, as in JAX."""
    rng = np.random.default_rng(15)
    c = np.stack([np.zeros(64, np.complex64),
                  _echo_autocorr(rng, 1, 64)[0]])
    guarded = tc._guard(torch.from_numpy(c))
    got = tc.levinson_first_col(guarded).numpy()
    assert np.all(np.isfinite(got))
    want = np.zeros(64, np.complex64)
    want[0] = np.float32(1.0) / np.float32(1e-25)
    np.testing.assert_array_equal(got[0], want)
    jx = _jax_levinson(guarded.numpy())
    assert np.all(np.isfinite(jx))
    np.testing.assert_allclose(got[0], jx[0], rtol=1e-6)
    assert _rel(got[1], jx[1]) < TOL


@pytest.mark.parametrize("m", [1, 2, 33, 210])
def test_levinson_plain_matches_jax_at_order(m):
    """m = 1 (no step), 2, 33 (one past a warp) and 210 (the 8-channel
    wideband band); 6 systems each, in a (2, 3, m) batch."""
    rng = np.random.default_rng(100 + m)
    c = _echo_autocorr(rng, 6, m).reshape(2, 3, m)
    got = tc.levinson_first_col(torch.from_numpy(c)).numpy()
    assert got.shape == (2, 3, m)
    assert _rel(got, _jax_levinson(c)) < TOL


@pytest.mark.parametrize("bad", [
    "complex128", "float32", "rank1", "rank3", "order0", "strided"])
def test_levinson_wrapper_refuses_before_loading(monkeypatch, bad):
    """dtype, rank, an empty order and a non-contiguous view raise
    ValueError before the library is looked at."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(lk, "_library", no_library)
    good = torch.zeros((2, 8), dtype=torch.complex64)
    c = dict(complex128=good.to(torch.complex128),
             float32=torch.zeros((2, 8)),
             rank1=good[0],
             rank3=good[None],
             order0=torch.zeros((2, 0), dtype=torch.complex64),
             strided=torch.zeros((2, 16), dtype=torch.complex64)[:, ::2])[bad]
    before = lk.levinson_first_col_kernel.launches
    with pytest.raises(ValueError):
        lk.levinson_first_col_kernel(c)
    assert lk.levinson_first_col_kernel.launches == before


def test_levinson_wrapper_on_cpu_is_the_plain_loop(monkeypatch):
    """On CPU tensors the wrapper and clutter.levinson_first_col return the
    plain loop's result bit for bit, launch nothing and load nothing."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(lk, "_library", no_library)
    c = torch.from_numpy(_echo_autocorr(np.random.default_rng(16), 5, 40))
    want = lk.levinson_first_col_plain(c)
    before = lk.levinson_first_col_kernel.launches
    assert torch.equal(lk.levinson_first_col_kernel(c), want)
    assert torch.equal(tc.levinson_first_col(c), want)
    assert lk.levinson_first_col_kernel.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 32, 33, 64, 65, 512, 513, 2048])
def test_levinson_kernel_at_variant_boundaries(cuda, m):
    """The kernel on either side of each register variant's order (32 I
    entries a lane, I = 1, 2, … 16) and in the shared variant (513, 2048),
    float32, 8 systems: one launch, finite, within TOL of the plain loop
    on the card, and no farther than LEVINSON_VS_F64 times the plain loop
    from the complex128 recursion."""
    c = torch.from_numpy(_echo_autocorr(np.random.default_rng(200 + m), 8,
                                        m)).to(cuda)
    before = lk.levinson_first_col_kernel.launches
    got = lk.levinson_first_col_kernel(c)
    assert lk.levinson_first_col_kernel.launches == before + 1
    plain = lk.levinson_first_col_plain(c)
    f64 = lk.levinson_first_col_plain(c.to(torch.complex128))
    torch.cuda.synchronize()
    got, plain, f64 = (x.cpu().numpy() for x in (got, plain, f64))
    assert np.all(np.isfinite(got))
    assert _per_system_rel(got, plain) < TOL
    assert _per_system_rel(got, f64) <= \
        LEVINSON_VS_F64 * _per_system_rel(plain.astype(np.complex128), f64)


@pytest.mark.parametrize("n,m,peek,fs", [(8192, 34, 10, 8192.0),
                                         (4096, 26, 10, 4096 / 0.9998442),
                                         (4096, 26, 10, 4096 / 3.3)])
def test_stage_tables_bit_equal_to_per_call_tables(n, m, peek, fs):
    """The cached edge phases, bin frequencies, roll ramp, Toeplitz
    indices and bin-pair indices equal the tables the stage made per call
    before (the same numpy and torch expressions)."""
    dev = torch.device("cpu")
    mus = [float(f) * (n / fs) for f in BINS]

    def old_tab(tau):
        cyc = np.mod(np.outer(np.asarray(mus), tau / n), 1.0)
        return torch.from_numpy(np.exp(2j * np.pi * cyc).astype(
            np.complex64))

    tau_h = np.arange(peek, peek + m, dtype=np.float64)
    tau_t = np.arange(n - m + peek, n + peek, dtype=np.float64)
    tau_t = np.where(tau_t < n, tau_t, tau_t - n)
    heads, tails = tc._edge_phases(tuple(mus), n, m, peek, dev)
    assert torch.equal(heads, old_tab(tau_h))
    assert torch.equal(tails, old_tab(tau_t))
    assert torch.equal(tc._bin_freqs(tuple(float(b) for b in BINS), dev),
                       torch.tensor(np.asarray(BINS, np.float32)))
    ramp = torch.from_numpy(np.exp(
        2j * np.pi * np.mod(np.arange(n, dtype=np.float64) * peek / n, 1.0)
    ).astype(np.complex64))
    assert torch.equal(tc._roll_ramp(n, peek, dev), ramp)
    d = np.arange(m)[:, None] - np.arange(m)[None, :]
    idx, lower = tc._toeplitz_index(m, dev)
    assert torch.equal(idx, torch.from_numpy(np.abs(d)))
    assert torch.equal(lower, torch.from_numpy(d >= 0))
    pairs, ai, bi = tc._pair_index(len(BINS), dev)
    assert pairs == [(a, b) for b in range(5) for a in range(b)]
    assert ai.tolist() == [p[0] for p in pairs]
    assert bi.tolist() == [p[1] for p in pairs]


@pytest.mark.parametrize("phase", [0.0, 0.7, "batch"])
def test_frequency_shift_tables_bit_equal_to_per_call_tables(phase):
    """mixer.frequency_shift with the cached oscillator tables and scalar
    phase equals the per-call tables' product."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(_cn(rng, 3, 9000))
    fc, fs = 1.0, 9000 / 0.9998442
    ph = torch.from_numpy(rng.random(3).astype(np.float32)) \
        if phase == "batch" else phase
    coarse, fine = tmixer._phase_tables(fc / fs, 9000)
    osc = (torch.from_numpy(coarse)[:, None]
           * torch.from_numpy(fine)[None, :]).reshape(-1)[:9000]
    want = x * osc * tmixer.phase_rotor(
        torch.as_tensor(ph, dtype=torch.float32))[..., None]
    assert torch.equal(tmixer.frequency_shift(x, fc, fs, ph), want)


def _frames(rng, n=2048):
    """Two frames of a reference and a surveillance channel with an echo;
    the second frame all zero (a margin frame)."""
    ref = _cn(rng, 2, n)
    srv = (np.roll(ref, 2, axis=-1) + 0.05 * _cn(rng, 2, n)).astype(
        np.complex64)
    ref[1] = srv[1] = 0
    return torch.from_numpy(ref), torch.from_numpy(srv)


@pytest.mark.parametrize("impl", tc.IMPLS)
@pytest.mark.parametrize("solver", tc.SOLVERS)
def test_graphed_stage_on_cpu_is_the_eager_stage(impl, solver):
    """On CPU tensors the graphed stage runs the eager one: bit-equal, no
    graph kept."""
    ref, srv = _frames(np.random.default_rng(18))
    fs = 2048 / 0.9998442
    want = tc.ls_filter_multiple(ref, srv, 12, fs, BINS, solver=solver,
                                 impl=impl)
    got = tc.ls_filter_multiple_graphed(ref, srv, 12, fs, BINS,
                                        solver=solver, impl=impl)
    assert torch.equal(got, want)
    assert torch.all(got[1] == 0)
    assert graphs.cache_info() == []


def test_clutter_stage_as_the_pipeline_calls_it_matches_jax():
    """pipeline.clutter_batch (LS through the graphed stage, on the CPU)
    against the JAX package's clutter_batch at the TINY geometry, with a
    zero margin frame, at tests/test_torch_ops.py's solver-equivalence
    bound; the zero frame stays zero in both."""
    import jax.numpy as jnp

    from passiveradar_torch.config import derive_config as t_derive
    from passiveradar_torch.pipeline import clutter_batch as t_clutter
    from passiveradar_tpu.config import derive_config as j_derive
    from passiveradar_tpu.pipeline import clutter_batch as j_clutter

    cfg_t, cfg_j = t_derive(TINY), j_derive(TINY)
    n = cfg_t.output_chunk_length
    rng = np.random.default_rng(20)
    ref = _cn(rng, 3, n)
    srv = (np.roll(ref, 3, axis=-1) + 0.05 * _cn(rng, 3, n)).astype(
        np.complex64)
    ref[0] = srv[0] = 0
    got = t_clutter(ref, srv, cfg_t, device="cpu").numpy()
    want = np.asarray(j_clutter(jnp.asarray(ref), jnp.asarray(srv), cfg_j))
    assert got.shape == want.shape == (3, n)
    assert np.all(got[0] == 0) and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) < 2e-3 * np.max(np.abs(srv))
    assert np.linalg.norm(got) < 0.2 * np.linalg.norm(srv)
