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
    CHUNK, FACTOR_TOL, mix_regroup_matmul, mix_regroup_matmul_plain,
    pack_bank)

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
    """The packed FM bank holds every nonzero tap of ``bank_ri`` row by
    phase and drops only trailing all-zero columns (the rest is padded with
    zeros to a whole chunk)."""
    up = 13
    st = _fm_static(119 * 160, mode=mode)
    bank = st["bank_ri"]
    packed = pack_bank(torch.from_numpy(bank), up)
    taps = packed.taps.numpy()
    w = int(np.flatnonzero(bank.any(0))[-1]) + 1
    wp = taps.shape[1]
    assert taps.shape == (up, wp, 2) and wp < bank.shape[1]
    assert wp == -(-w // CHUNK) * CHUNK and packed.chunk == CHUNK
    assert not np.any(bank[:, w:]) and np.any(bank[:, w - 1])
    np.testing.assert_array_equal(taps[:, :w, 0], bank[:up, :w])
    np.testing.assert_array_equal(taps[:, :w, 1], bank[up:, :w])
    assert not np.any(taps[:, w:])


def _banded_bank(rng, up=5, w=77):
    """A random bank with zeroed bands: each phase nonzero on its own run of
    columns, an interior run of all-zero chunks, and one phase all zero."""
    bank = rng.standard_normal((2 * up, w)).astype(np.float32)
    for p in range(up):
        keep = np.zeros(w, bool)
        keep[3 + 9 * p:3 + 9 * p + 40] = True
        bank[p, ~keep] = bank[up + p, ~keep] = 0
    bank[:, 24:48] = 0
    bank[2] = bank[up + 2] = 0
    return bank, up


_TABLE_CASES = [(13, 119, m) for m in ("line", "constant")] + \
    [(u, d, m) for u, d in [(1, 3), (2, 7), (3, 17)]
     for m in ("line", "constant")] + [("banded", None, None)]


def _table_case(rng, case):
    """(bank_ri, up, down) of a table case: the designed bank at a ratio and
    pad type, or the random banded bank (down 7)."""
    up, down, mode = case
    if up == "banded":
        bank, up = _banded_bank(rng)
        return bank, up, 7
    n_in = down * 140 + 5
    h_pad, _, _ = tfir._resample_design(n_in, up, down, ("kaiser", 5.0))
    st = tfir._mix_resample_static(h_pad.tobytes(), up, down, FC / FS, n_in,
                                   mode)
    return st["bank_ri"], up, down


@pytest.mark.parametrize("case", _TABLE_CASES, ids=str)
def test_pack_bank_phase_table_covers_every_nonzero_tap(rng, case):
    """Each chunk's [first, last] phase range holds every phase with a
    nonzero tap in the chunk's columns, and its ends have one (an empty
    chunk has first > last)."""
    bank, up, _ = _table_case(rng, case)
    packed = pack_bank(torch.from_numpy(bank), up)
    taps, phases = packed.taps.numpy(), packed.phases.numpy()
    k = packed.chunk
    assert phases.shape == (taps.shape[1] // k, 2) and taps.shape[1] % k == 0
    for c, (pa, pb) in enumerate(phases):
        live = np.flatnonzero(taps[:, c * k:(c + 1) * k].any(axis=(1, 2)))
        if live.size == 0:
            assert pa > pb, (c, pa, pb)
        else:
            assert (pa, pb) == (live[0], live[-1]), (c, pa, pb, live)
    if case[0] == "banded":
        assert (phases[:, 0] > phases[:, 1]).sum() >= 2   # interior zeros


def _warp_pairs(phases, ksplit):
    """The kernel's split of the live (chunk, phase) pairs over its warps:
    in chunk order, warp w takes pairs [w·total/ksplit, (w+1)·total/ksplit).
    Returns, per warp, a list of (chunk, first phase, last phase)."""
    live = np.maximum(0, phases[:, 1] - phases[:, 0] + 1)
    total = int(live.sum())
    runs = []
    for w in range(ksplit):
        b0, b1 = w * total // ksplit, (w + 1) * total // ksplit
        mine, cum = [], 0
        for c, a in enumerate(live):
            pa = phases[c, 0] + max(0, b0 - cum)
            pb = phases[c, 0] + min(a, b1 - cum) - 1
            if a > 0 and pa <= pb:
                mine.append((c, pa, pb))
            cum += a
        runs.append(mine)
    return runs


def _chunked_model(x, packed, down, groups, up, pad_left, ksplit=8,
                   factors=True):
    """numpy model of the kernel's sum: each warp runs only its share of
    the table's live (chunk, phase) pairs, on the bank's factors when it has
    them (each sample turned by its column's phasor, then real taps); then
    the warps' partials are added."""
    taps = packed.taps.numpy()
    phases = packed.phases.numpy()
    k = packed.chunk
    bc = (taps[..., 0] + 1j * taps[..., 1]).astype(np.complex64)
    use = factors and packed.real is not None
    if use:
        ph = packed.phasor.numpy()
        turn = (ph[:, 0] + 1j * ph[:, 1]).astype(np.complex64)
        real = packed.real.numpy()
    xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    wp = bc.shape[1]
    total = (groups - 1) * down + wp
    xp = np.zeros((x.shape[0], max(total, pad_left + x.shape[1])), np.complex64)
    xp[:, pad_left:pad_left + x.shape[1]] = xc
    idx = np.arange(groups)[:, None] * down + np.arange(wp)[None, :]
    win = xp[:, idx]                                       # (F, groups, Wp)
    if use:
        win = win * turn
    out = np.zeros((x.shape[0], groups, up), np.complex64)
    runs = _warp_pairs(phases, ksplit)
    assert sum((pb - pa + 1) for r in runs for _, pa, pb in r) == \
        int(np.maximum(0, phases[:, 1] - phases[:, 0] + 1).sum())
    for mine in runs:
        part = np.zeros_like(out)
        for c, pa, pb in mine:
            cols = slice(c * k, (c + 1) * k)
            b = real[pa:pb + 1, cols] if use else bc[pa:pb + 1, cols]
            part[:, :, pa:pb + 1] += win[:, :, cols] @ b.T
        out += part
    return out


@pytest.mark.parametrize("case,factors", [
    (c, f) for c in _TABLE_CASES
    for f in ((False, True) if c[0] != "banded" else (False,))],
    ids=str)
def test_chunked_phase_skip_model_matches_plain(rng, case, factors):
    """The kernel's chunked sum that skips the phases outside each chunk's
    table range, split over eight warps, on the complex taps or on the
    bank's real factors, equals the dense plain version within 2e-6 of the
    peak."""
    bank, up, down = _table_case(rng, case)
    packed = pack_bank(torch.from_numpy(bank), up)
    assert (packed.real is not None) == (case[0] != "banded")
    frames, n = 2, down * 140 + 5
    pad = down // 2 + 1
    groups = (n + pad - packed.taps.shape[1]) // down + 2
    x = rng.standard_normal((frames, n, 2)).astype(np.float32)
    want = mix_regroup_matmul_plain(torch.from_numpy(x), packed, down, groups,
                                    up, pad).numpy()
    got = _chunked_model(x, packed, down, groups, up, pad, factors=factors)
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("case", _TABLE_CASES, ids=str)
def test_pack_bank_factors_only_phasor_banks(rng, case):
    """The mixer's folded banks factor as real taps times one unit phasor a
    column, to FACTOR_TOL of the peak; a random bank does not."""
    bank, up, _ = _table_case(rng, case)
    packed = pack_bank(torch.from_numpy(bank), up)
    if case[0] == "banded":
        assert packed.real is None and packed.phasor is None
        return
    tc = torch.view_as_complex(packed.taps)
    turn = torch.view_as_complex(packed.phasor)
    assert packed.real.shape == tc.shape and turn.shape == tc.shape[1:]
    np.testing.assert_allclose(turn.abs().numpy(), 1.0, rtol=1e-6)
    err = (packed.real * turn - tc).abs().max() / tc.abs().max()
    assert err <= FACTOR_TOL


def test_pack_bank_fm_macs_per_group():
    """At the FM geometry the table leaves at most 2,600 complex MACs a
    group of the 13 × 294 a dense pass runs, and no fewer than the bank's
    nonzero taps."""
    up = 13
    bank = _fm_static(119 * 160)["bank_ri"]
    packed = pack_bank(torch.from_numpy(bank), up)
    ph = packed.phases.numpy()
    run = int(np.maximum(0, ph[:, 1] - ph[:, 0] + 1).sum()) * packed.chunk
    nonzero = int(np.count_nonzero((bank[:up] != 0) | (bank[up:] != 0)))
    assert nonzero <= run <= 2600 < up * 294


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
