"""The port's resampler against the JAX package, on the CPU.

The kernel contract (``mix_regroup_matmul``: the CUDA kernel's plain torch
version, which is what a CPU tensor runs) is held against the Pallas TPU
kernel in interpret mode; the fused batch resampler against the JAX batch
path with the Pallas kernel forced on; the float64 host constants element
for element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.ops import fir as jfir  # noqa: E402
from passiveradar_tpu.ops.resample_pallas import \
    mix_regroup_matmul as jax_mix_regroup  # noqa: E402
from passiveradar_torch.ops import fir as tfir  # noqa: E402
from passiveradar_torch.ops.resample_kernel import (  # noqa: E402
    mix_regroup_matmul, mix_regroup_matmul_plain, pack_bank)

FC, FS = 100_000.0, 2_400_000.0


def _fm_static(n_in, up=13, down=119, mode="line"):
    h_pad, _, _ = jfir._resample_design(n_in, up, down, ("kaiser", 5.0))
    return jfir._mix_resample_static(jfir._tap_key(h_pad), up, down,
                                     FC / FS, n_in, mode)


@pytest.mark.parametrize("up,down", [(13, 119), (1, 3), (2, 7), (3, 17)])
def test_mix_regroup_matmul_matches_pallas_interpret(rng, up, down):
    """Plain kernel contract vs the Pallas kernel (interpret mode), with the
    left pad staged by the callee as the main path does."""
    frames = 3
    if (up, down) == (13, 119):
        n = 119 * 160
        st = _fm_static(n)
        bank = st["bank_ri"]
        groups, pad = st["groups"], st["pad_l"] + st["ext"]
    else:
        n = down * 140 + 5
        w = 3 * down
        bank = rng.standard_normal((2 * up, w)).astype(np.float32)
        pad = down // 2 + 1
        groups = (n + pad - w) // down + 2
    pr = rng.standard_normal((frames, n)).astype(np.float32)
    pi = rng.standard_normal((frames, n)).astype(np.float32)
    want_re, want_im = jax_mix_regroup(jnp.asarray(pr), jnp.asarray(pi),
                                       jnp.asarray(bank), down, groups, up,
                                       interpret=True, pad_left=pad)
    x = torch.from_numpy(np.stack([pr, pi], axis=-1))
    before = mix_regroup_matmul.launches
    got = mix_regroup_matmul(x, pack_bank(torch.from_numpy(bank), up), down,
                             groups, up, pad_left=pad).numpy()
    assert mix_regroup_matmul.launches == before   # CPU: no kernel launch
    want = np.asarray(want_re) + 1j * np.asarray(want_im)
    assert got.shape == (frames, groups, up)
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


def test_mix_regroup_plain_rejects_bad_layout(rng):
    bank = torch.zeros((10, 2, 2))
    with pytest.raises(ValueError, match="IQ pairs"):
        mix_regroup_matmul_plain(torch.zeros((2, 50)), bank, 3, 10, 2)
    with pytest.raises(ValueError, match="pack_bank"):
        mix_regroup_matmul_plain(torch.zeros((2, 50, 2)), bank, 3, 10, 3)
    with pytest.raises(ValueError, match="2\\*up"):
        pack_bank(torch.zeros((4, 10)), 3)


@pytest.mark.parametrize("mode", ["line", "constant"])
def test_pack_bank_drops_only_zero_columns(mode):
    """The packed FM bank holds every nonzero tap of ``bank_ri`` in
    (column, phase) order and drops only trailing all-zero columns."""
    up = 13
    st = _fm_static(119 * 160, mode=mode)
    bank = st["bank_ri"]
    packed = pack_bank(torch.from_numpy(bank), up).numpy()
    w = packed.shape[0]
    assert packed.shape == (w, up + 1, 2) and w < bank.shape[1]
    assert not np.any(bank[:, w:]) and np.any(bank[:, w - 1])
    np.testing.assert_array_equal(packed[:, :up, 0], bank[:up, :w].T)
    np.testing.assert_array_equal(packed[:, :up, 1], bank[up:, :w].T)
    assert not np.any(packed[:, up:])


@pytest.mark.parametrize("padtype", ["line", "constant"])
def test_mix_resample_poly_batch_matches_jax_pallas(rng, monkeypatch,
                                                    padtype):
    """Fused batch resampler at the FM ratio vs the JAX batch path running
    the Pallas kernel (the route the JAX tests force with the env gate)."""
    up, down = 13, 119
    n_in, frames = 119 * 160, 3
    x = rng.standard_normal((frames, n_in, 2)).astype(np.float32)
    phases = rng.standard_normal(frames).astype(np.float32)
    monkeypatch.setenv("PASSIVERADAR_PALLAS_RESAMPLE", "1")
    want = np.asarray(jfir.mix_resample_poly_batch(
        jnp.asarray(x), jnp.asarray(phases), FC, FS, up, down,
        padtype=padtype))
    got = tfir.mix_resample_poly_batch(
        torch.from_numpy(x), torch.from_numpy(phases), FC, FS, up, down,
        padtype=padtype).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("up,down", [(1, 3), (2, 7), (1, 1)])
def test_mix_resample_poly_batch_other_ratios(rng, up, down):
    """Other ratios (incl. the pure-mixer 1/1 case) vs the JAX batch entry."""
    n_in, frames = 2048, 2
    x = rng.standard_normal((frames, n_in, 2)).astype(np.float32)
    phases = rng.standard_normal(frames).astype(np.float32)
    want = np.asarray(jfir.mix_resample_poly_batch(
        jnp.asarray(x), jnp.asarray(phases), 5_000.0, 96_000.0, up, down,
        padtype="line"))
    got = tfir.mix_resample_poly_batch(
        torch.from_numpy(x), torch.from_numpy(phases), 5_000.0, 96_000.0,
        up, down, padtype="line").numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("mode", ["line", "constant"])
def test_mix_resample_static_equals_jax(mode):
    """The float64-derived host constants equal the JAX package's."""
    n_in = 119 * 160 + 7
    h_pad, _, _ = jfir._resample_design(n_in, 13, 119, ("kaiser", 5.0))
    want = jfir._mix_resample_static(jfir._tap_key(h_pad), 13, 119, FC / FS,
                                     n_in, mode)
    got = tfir._mix_resample_static(h_pad.tobytes(), 13, 119, FC / FS, n_in,
                                    mode)
    for key in ("pad_l", "ext", "groups", "n_slabs", "shift", "n_out_plain"):
        assert got[key] == want[key], key
    for key in ("bank_ri", "bank_c64", "fg"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0)
    if mode == "constant":
        assert got["corr"] is None and want["corr"] is None
        return
    assert got["corr"][:2] == want["corr"][:2]
    for a, b in zip(got["corr"][2:], want["corr"][2:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("up,down,padtype", [(13, 119, "line"),
                                             (1, 4, "constant"),
                                             (3, 2, "line")])
def test_resample_poly_matches_jax(rng, up, down, padtype):
    n = 3000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    want = np.asarray(jfir.resample_poly(jnp.asarray(x), up, down,
                                         padtype=padtype))
    got = tfir.resample_poly(torch.from_numpy(x), up, down,
                             padtype=padtype).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("q", [2, 5])
def test_fir_decimate_matches_jax(rng, q):
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
        np.complex64)
    want = np.asarray(jfir.fir_decimate(jnp.asarray(x), q))
    got = tfir.fir_decimate(torch.from_numpy(x), q).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))
