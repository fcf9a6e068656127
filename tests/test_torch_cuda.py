"""Card-only checks of the port: the CUDA kernels against their plain
versions, and the whole chain and the streaming processor on the card
against the CPU.

Marked ``cuda``; each test skips when no CUDA card is present (decided in
the fixture, at run time). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_torch.config import derive_config  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_arrays)
from passiveradar_torch.ops import fft_kernel as fk  # noqa: E402
from passiveradar_torch.ops import nlms_kernel as nk  # noqa: E402
from passiveradar_torch.ops import resample_kernel as rk  # noqa: E402
from passiveradar_torch.ops.clutter import (  # noqa: E402
    ls_filter_multiple, ls_filter_multiple_graphed)
from passiveradar_torch.pipeline import frame_phases, process_frames  # noqa: E402
from passiveradar_torch.streaming import StreamingProcessor  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("up,down,frames", [(13, 119, 3), (1, 3, 2),
                                            (3, 17, 11), (20, 21, 2)])
def test_mix_regroup_kernel_matches_plain(cuda, up, down, frames):
    """Kernel vs its plain version on the same card tensors, across phase
    counts (template instantiations), ragged group tiles and left pads."""
    gen = torch.Generator(device=cuda).manual_seed(up * 1000 + down)
    w = 3 * down
    n = down * 150 + 7
    pad = down + 5
    groups = (n + pad - w) // down + 3
    x = torch.randn((frames, n, 2), generator=gen, device=cuda)
    bank = rk.pack_bank(torch.randn((2 * up, w), generator=gen, device=cuda),
                        up)
    before = rk.mix_regroup_matmul.launches
    got = rk.mix_regroup_matmul(x, bank, down, groups, up, pad)
    assert rk.mix_regroup_matmul.launches == before + 1
    want = rk.mix_regroup_matmul_plain(x, bank, down, groups, up, pad)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= 2e-6 * peak


def _banded_bank(rng, up, w, band=(24, 48), dead_phase=None):
    """A random (2·up, w) bank, each phase nonzero on its own run of columns,
    with an interior band of all-zero columns and optionally a zero phase."""
    bank = rng.standard_normal((2 * up, w)).astype(np.float32)
    step = w // (2 * up)
    run = w - (up - 1) * step
    for p in range(up):
        keep = np.zeros(w, bool)
        keep[p * step:p * step + run] = True
        bank[p, ~keep] = bank[up + p, ~keep] = 0
    bank[:, band[0]:band[1]] = 0
    if dead_phase is not None:
        bank[dead_phase] = bank[up + dead_phase] = 0
    return bank


def _turned(rng, bank, up):
    """The bank's real rows times one random unit phasor a column: a bank
    that pack_bank factors, as it does the mixer's."""
    turn = np.exp(2j * np.pi * rng.random(bank.shape[1]))
    b = bank[:up] * turn
    return np.concatenate([b.real, b.imag]).astype(np.float32)


# (name, up, down, frames, bank kind, pad_left in units of down, group
# count over the tiles the samples fill); a kind ending in "_fac" is a bank
# that factors, which runs the kernel's real-tap path
_REGROUP_CASES = [
    ("zero_chunks", 13, 119, 3, "banded", 1, 3),
    ("zero_chunks_fac", 13, 119, 3, "banded_fac", 1, 3),
    ("no_zero_tap", 13, 119, 2, "dense", 2, 3),
    ("no_zero_tap_fac", 13, 119, 2, "dense_fac", 2, 3),
    ("push_F1", 13, 119, 1, "banded_fac", 3, 0),
    ("ragged_tile", 3, 17, 5, "banded_fac", 1, 37),
    ("pad_beyond_tile", 3, 17, 2, "dense", 70, 5),
    ("up1", 1, 3, 3, "banded_fac", 1, 11),
    ("up20", 20, 21, 2, "banded", 2, 29),
    ("up20_fac", 20, 21, 2, "banded_fac", 2, 29),
    ("narrow_tile", 3, 600, 2, "banded", 1, 5),
    ("narrow_tile_fac", 3, 600, 2, "banded_fac", 1, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _REGROUP_CASES, ids=lambda c: c[0])
def test_mix_regroup_kernel_cases(cuda, case):
    """Kernel vs plain on banks with interior all-zero chunks and with no
    zero tap, one frame, a ragged last tile, a left pad beyond the first
    64-group tile, up = 1 and 20, and a span too wide for a 64-group item
    (the kernel narrows it to 32); on complex taps and on factored banks."""
    name, up, down, frames, kind, pad_downs, extra = case
    rng = np.random.default_rng(sum(map(ord, name)))
    w = max(40, 3 * down - 5)
    bank = (_banded_bank(rng, up, w, band=(w // 3, w // 3 + 16),
                         dead_phase=up // 2 if up > 2 else None)
            if kind.startswith("banded") else
            rng.standard_normal((2 * up, w)).astype(np.float32))
    if kind.endswith("_fac"):
        bank = _turned(rng, bank, up)
    packed = rk.pack_bank(torch.from_numpy(bank).to(cuda), up)
    assert (packed.real is not None) == kind.endswith("_fac")
    ph = packed.phases.cpu().numpy()
    if kind.startswith("banded"):
        assert (ph[:, 0] > ph[:, 1]).any()         # an empty chunk inside
    else:
        assert (ph == [0, up - 1]).all()
    n = down * 200 + 7
    pad = pad_downs * down + 5
    groups = (n + pad - w) // down + extra
    if name == "ragged_tile":
        assert groups % 64 != 0
    x = torch.from_numpy(rng.standard_normal((frames, n, 2)).astype(
        np.float32)).to(cuda)
    before = rk.mix_regroup_matmul.launches
    got = rk.mix_regroup_matmul(x, packed, down, groups, up, pad)
    assert rk.mix_regroup_matmul.launches == before + 1
    want = rk.mix_regroup_matmul_plain(x, packed, down, groups, up, pad)
    torch.cuda.synchronize()
    assert got.shape == (frames, groups, up)
    err = (got - want).abs().max().item()
    assert err <= 2e-6 * want.abs().max().item()
    info = (ctypes.c_int * 4)()
    rk._library().mix_regroup_last_launch(info)
    assert info[3] == (32 if name.startswith("narrow") else 64)


@pytest.mark.cuda
def test_mix_regroup_kernel_rejects_cpu_bank(cuda):
    x = torch.zeros((1, 100, 2), device=cuda)
    with pytest.raises(ValueError, match="same device"):
        rk.mix_regroup_matmul(x, rk.pack_bank(torch.ones((2, 9)), 1), 3, 30,
                              1)


def _nlms_inputs(cuda, frames, n, m, seed):
    """Clutter-like inputs on the card; frame 1 holds a zero run longer
    than m in ref, so it has all-zero windows."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ref = torch.randn((frames, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    ref[1, n // 3:n // 3 + m + 40] = 0
    srv = 0.5 * torch.roll(ref, 3, dims=1) + 0.1 * torch.randn(
        (frames, n), dtype=torch.complex64, generator=gen, device=cuda)
    return ref, srv


def _assert_nlms_agree(got, want):
    """Equal NaN masks; the finite parts within 1e-5 of the peak."""
    mask = torch.isnan(want)
    assert torch.equal(torch.isnan(got), mask)
    g, w = got[~mask], want[~mask]
    assert torch.isfinite(g).all()
    assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("flen,peek,zero_window", [
    (175, 10, "zero"), (175, 10, "nan"), (23, 10, "zero"), (23, 10, "nan"),
    (502, 10, "zero"), (1, 0, "zero")])
def test_nlms_kernel_matches_plain(cuda, flen, peek, zero_window):
    """Kernel vs its plain version across tap counts (template
    instantiations 6, 2, 16 and 1), both zero-window semantics, with one
    frame holding all-zero windows."""
    ref, srv = _nlms_inputs(cuda, 3, 3000, flen + peek, flen)
    before = nk.nlms_filter_batch.launches
    got, gtaps = nk.nlms_filter_batch(ref, srv, flen, 0.05, peek=peek,
                                      return_filter=True,
                                      zero_window=zero_window)
    assert nk.nlms_filter_batch.launches == before + 1
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, flen, 0.05, peek=peek,
                                             return_filter=True,
                                             zero_window=zero_window)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)
    assert torch.isnan(got[1]).any() == (zero_window == "nan")
    assert not torch.isnan(got[[0, 2]]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("zero_window", ["zero", "nan"])
@pytest.mark.parametrize("where,flen", [("block_edge", 175), ("mid_block", 175),
                                        ("block_edge", 23), ("mid_block", 502)])
def test_nlms_kernel_block_edges_match_plain(cuda, where, flen, zero_window):
    """The block form's edges: a zero run whose first all-zero window is a
    block's first step or a step inside a block, 4,003 samples (steps no
    multiple of the block), m = 33, 185 and 512."""
    m = flen + 10
    n = 4003
    p_block = nk._library().nlms_block_steps()
    start = 5 * p_block + (1 if where == "block_edge" else 14)
    gen = torch.Generator(device=cuda).manual_seed(start + flen)
    ref = torch.randn((3, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    ref[1, start:start + m + 50] = 0      # first zero window: step start-1
    srv = 0.5 * torch.roll(ref, 3, dims=1) + 0.1 * torch.randn(
        (3, n), dtype=torch.complex64, generator=gen, device=cuda)
    assert (n - m) % p_block != 0
    got, gtaps = nk.nlms_filter_batch(ref, srv, flen, 0.05,
                                      return_filter=True,
                                      zero_window=zero_window)
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, flen, 0.05,
                                             return_filter=True,
                                             zero_window=zero_window)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)
    if zero_window == "nan":
        first = flen + start - 1          # the first zero window's output
        assert torch.isfinite(got[1, :first + 1]).all()
        assert torch.isnan(got[1, first + 1:n - 10]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("zero_window", ["zero", "nan"])
@pytest.mark.parametrize("flen", [175, 502])
def test_nlms_kernel_tiny_sample_after_zero_run_matches_plain(cuda, flen,
                                                              zero_window):
    """A zero run whose first sample after it is scaled by 1e-4, the run
    ending at a block's edge: the windows at its far edge hold that one
    small sample, so u^H u is ~1e-8 and M's entries are large there; m =
    185 and 512, both zero-window semantics."""
    m = flen + 10
    n = 4003
    p_block = nk._library().nlms_block_steps()
    start = 5 * p_block + 1
    # the first window holding ref[end] is step 12 P, a block's first
    end = 12 * p_block + m
    gen = torch.Generator(device=cuda).manual_seed(end + flen)
    ref = torch.randn((3, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    ref[1, start:end] = 0
    ref[1, end] *= 1e-4
    srv = 0.5 * torch.roll(ref, 3, dims=1) + 0.1 * torch.randn(
        (3, n), dtype=torch.complex64, generator=gen, device=cuda)
    got, gtaps = nk.nlms_filter_batch(ref, srv, flen, 0.05,
                                      return_filter=True,
                                      zero_window=zero_window)
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, flen, 0.05,
                                             return_filter=True,
                                             zero_window=zero_window)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)
    assert torch.isnan(got[1]).any() == (zero_window == "nan")


@pytest.mark.cuda
def test_nlms_kernel_push_shape_matches_plain(cuda):
    """One frame of 262,144 samples at the FM taps, as a stream's push
    launches it (F = 1), against the plain version."""
    ref, srv = _nlms_inputs(cuda, 2, 262_144, 185, 3)
    ref, srv = ref[:1].contiguous(), srv[:1].contiguous()
    got, gtaps = nk.nlms_filter_batch(ref, srv, 175, 0.05,
                                      return_filter=True)
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, 175, 0.05,
                                             return_filter=True)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)


def _first_frames(cuda, ctas):
    """The fewest frames whose kernel launch takes ``ctas`` CTAs a frame."""
    for frames in range(1, 1024):
        if nk.cluster_ctas(frames, cuda) == ctas:
            return frames
    raise AssertionError(f"no launch of under 1024 frames takes {ctas} "
                         f"CTAs a frame")


@pytest.mark.cuda
@pytest.mark.parametrize("zero_window", ["zero", "nan"])
@pytest.mark.parametrize("ctas,flen,peek,warm", [
    (2, 175, 10, False), (2, 23, 10, False), (1, 175, 10, False),
    (1, 23, 10, False), (1, 502, 10, False), (1, 1, 0, False),
    (1, 175, 10, True), (2, 175, 10, True)])
def test_nlms_kernel_each_cluster_design_matches_plain(cuda, ctas, flen,
                                                       peek, warm,
                                                       zero_window):
    """Each design that the frame count picks (a cluster of the chain and
    a producer, or one CTA that solves each block) at the fewest frames
    (at least 3) that take it, against the plain version: m = 1, 33,
    185 and 512, both zero-window semantics, a warm start, frame 1 with
    all-zero windows and frame 2 with a zero run ending at a block's edge
    and a 1e-4 sample after it."""
    frames = max(3, _first_frames(cuda, ctas))
    assert nk.cluster_ctas(frames, cuda) == ctas
    m = flen + peek
    n = 2003
    ref, srv = _nlms_inputs(cuda, frames, n, m, 31 * ctas + flen)
    end = 12 * nk._library().nlms_block_steps() + m
    ref[2, end - m - 60:end] = 0
    ref[2, end] *= 1e-4
    taps = None
    if warm:
        _, taps = nk.nlms_filter_batch_plain(ref[:, :700], srv[:, :700],
                                             flen, 0.05, peek=peek,
                                             return_filter=True)
    got, gtaps = nk.nlms_filter_batch(ref, srv, flen, 0.05, peek=peek,
                                      return_filter=True, initial_taps=taps,
                                      zero_window=zero_window)
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, flen, 0.05, peek=peek,
                                             return_filter=True,
                                             initial_taps=taps,
                                             zero_window=zero_window)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)
    assert torch.isnan(got[1]).any() == (zero_window == "nan")
    assert not torch.isnan(got[0]).any()


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_card(cuda):
    """Inputs on card 1 while card 0 is current: both kernels launch there,
    agree with their plain versions and leave card 0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    gen = torch.Generator(device=one).manual_seed(11)
    ref = torch.randn((2, 3000), dtype=torch.complex64, generator=gen,
                      device=one)
    srv = 0.5 * torch.roll(ref, 3, dims=1)
    got = nk.nlms_filter_batch(ref, srv, 175, 0.05)
    want = nk.nlms_filter_batch_plain(ref, srv, 175, 0.05)
    x = torch.randn((2, 17 * 150 + 7, 2), generator=gen, device=one)
    bank = rk.pack_bank(torch.randn((6, 51), generator=gen, device=one), 3)
    got_r = rk.mix_regroup_matmul(x, bank, 17, 140, 3, 9)
    want_r = rk.mix_regroup_matmul_plain(x, bank, 17, 140, 3, 9)
    torch.cuda.synchronize(one)
    assert torch.cuda.current_device() == 0
    _assert_nlms_agree(got, want)
    assert (got_r - want_r).abs().max().item() <= \
        2e-6 * want_r.abs().max().item()


@pytest.mark.cuda
def test_nlms_kernel_warm_start_matches_plain(cuda):
    ref, srv = _nlms_inputs(cuda, 2, 2000, 40, 7)
    _, taps = nk.nlms_filter_batch(ref[:, :900], srv[:, :900], 30, 0.1,
                                   return_filter=True)
    got, gtaps = nk.nlms_filter_batch(ref, srv, 0, 0.1, initial_taps=taps,
                                      return_filter=True)
    want, wtaps = nk.nlms_filter_batch_plain(ref, srv, 0, 0.1,
                                             initial_taps=taps,
                                             return_filter=True)
    torch.cuda.synchronize()
    _assert_nlms_agree(got, want)
    _assert_nlms_agree(gtaps, wtaps)


@pytest.mark.cuda
def test_nlms_kernel_rejects_too_many_taps(cuda):
    x = torch.zeros((1, 2000), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="at most 512"):
        nk.nlms_filter_batch(x, x, 503, 0.05)


@pytest.mark.cuda
def test_process_frames_card_matches_cpu(cuda):
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0,
                             max_doppler_nominal=128.0,
                             max_range_nominal=400.0))
    nfr = 4
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    length = cfg.input_chunk_length
    ref = ref[:nfr * length].reshape(nfr, length)
    srv = srv[:nfr * length].reshape(nfr, length)
    ph = frame_phases(cfg, list(range(nfr)))
    got = process_frames(ref, srv, ph, cfg).cpu().numpy()
    want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))
    for f in range(nfr):
        assert np.argmax(np.abs(got[f])) == np.argmax(np.abs(want[f]))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nlms", "nlms_pallas"])
def test_process_frames_nlms_card_matches_cpu(cuda, method):
    """Both NLMS methods, card vs CPU, with zero frames at the batch edges:
    equal NaN masks under 'nlms' (frames 0, 1, 4, 5), all finite under
    'nlms_pallas'; finite frames within 1e-4 of the map peak, argmax
    equal."""
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0,
                             max_doppler_nominal=128.0,
                             max_range_nominal=400.0,
                             clutter_method=method))
    nfr = 6
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    length = cfg.input_chunk_length
    ref = ref[:nfr * length].reshape(nfr, length)
    srv = srv[:nfr * length].reshape(nfr, length)
    ref[[0, -1]] = 0
    srv[[0, -1]] = 0
    ph = frame_phases(cfg, list(range(nfr)))
    before = nk.nlms_filter_batch.launches
    got = process_frames(ref, srv, ph, cfg).cpu().numpy()
    assert nk.nlms_filter_batch.launches == before + 1
    want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = [f for f in range(nfr) if np.isfinite(want[f]).all()]
    assert finite == ([2, 3] if method == "nlms" else list(range(nfr)))
    g, w = got[finite], want[finite]
    assert np.max(np.abs(g - w)) < 1e-4 * np.max(np.abs(w))
    for f in range(len(finite)):
        assert np.argmax(np.abs(g[f])) == np.argmax(np.abs(w[f]))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,b", [(n, b) for n in sorted(fk._SPLITS)
                                 for b in (1, 3)] + [(262144, 30)])
def test_fft_fused_kernel_matches_plain(cuda, n, b, inverse):
    """Kernel vs its plain version and cuFFT on the same card tensors, at
    every split, one and three frames, and the LS clutter's 30 frames at
    2^18; tolerances of tests/test_mxufft.py (2e-5·√n forward, 2e-5
    inverse)."""
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    x = torch.randn((b, n), dtype=torch.complex64, generator=gen,
                    device=cuda)
    before = fk.fft_fused.launches
    got = fk.fft_fused(x, inverse=inverse)
    assert fk.fft_fused.launches == before + 1
    plain = fk.fft_fused_reference(x, inverse=inverse)
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    torch.cuda.synchronize()
    tol = 2e-5 if inverse else 2e-5 * n ** 0.5
    assert (got - plain).abs().max().item() < tol
    assert (got - lib).abs().max().item() < tol


@pytest.mark.cuda
def test_fft_fused_kernel_strided_and_real_input(cuda):
    """A strided view (as ls_filter_multiple's f_extra[:, 0]) is made
    contiguous; leading dims and real input as on the CPU; an input that
    is not 16-byte aligned is copied."""
    n = 65536
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 3, n), dtype=torch.complex64, generator=gen,
                    device=cuda)
    got = fk.fft_fused(x[:, 1])
    want = torch.fft.fft(x[:, 1])
    assert (got - want).abs().max().item() < 2e-5 * n ** 0.5
    got = fk.fft_fused(x.real)
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert (got - torch.fft.fft(x.real)).abs().max().item() < 2e-5 * n ** 0.5
    with pytest.raises(ValueError, match="unsupported length"):
        fk.fft_fused(x[..., :8192])
    # 8 bytes past an aligned start: copied, not read misaligned
    odd = torch.randn(n + 1, dtype=torch.complex64, generator=gen,
                      device=cuda)[1:]
    assert odd.data_ptr() % 16 == 8
    got = fk.fft_fused(odd)
    assert (got - torch.fft.fft(odd)).abs().max().item() < 2e-5 * n ** 0.5


@pytest.mark.cuda
def test_ls_filter_fused_route_launches_kernel(cuda, monkeypatch):
    """The LS canceller at n = 65,536 on the card: under the opt-in its two
    full-length transforms launch the kernel, and the result stays within
    2e-4 of the cuFFT route."""
    n = 65536
    gen = torch.Generator(device=cuda).manual_seed(5)
    ref = torch.randn((2, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    srv = 0.3 * torch.roll(ref, 7, dims=1) + 0.1 * torch.randn(
        (2, n), dtype=torch.complex64, generator=gen, device=cuda)
    bins = (0.0, 1.0, -1.0, 2.0, -2.0)
    monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)
    want = ls_filter_multiple(ref, srv, 22, float(n), bins)
    monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    before = fk.fft_fused.launches
    got = ls_filter_multiple(ref, srv, 22, float(n), bins)
    torch.cuda.synchronize()
    assert fk.fft_fused.launches == before + 2
    assert (got - want).abs().max().item() < 2e-4


@pytest.mark.cuda
def test_streaming_card_matches_cpu(cuda):
    """The streaming processor at TINY on the card against the CPU: CAFs
    within 1e-4 of the peak, track tables equal in status and lifetime."""
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0,
                             max_doppler_nominal=128.0,
                             max_range_nominal=400.0))
    nfr = 6
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.3),))
    length = cfg.input_chunk_length
    ref = ref[:nfr * length].reshape(nfr, length)
    srv = srv[:nfr * length].reshape(nfr, length)
    card = StreamingProcessor(cfg, n_tracks=4)
    host = StreamingProcessor(cfg, n_tracks=4, device="cpu")
    for f in range(nfr + 1):
        if f < nfr:
            got = card.push(torch.from_numpy(ref[f]).to(cuda),
                            torch.from_numpy(srv[f]).to(cuda))
            want = host.push(ref[f], srv[f])
        else:
            got, want = card.flush(), host.flush()
        if want is None:
            assert got is None
            continue
        peak = np.max(np.abs(want.caf))
        assert np.max(np.abs(got.caf - want.caf)) < 1e-4 * peak
        np.testing.assert_array_equal(got.tracks["status"],
                                      want.tracks["status"])
        np.testing.assert_array_equal(got.tracks["lifetime"],
                                      want.tracks["lifetime"])


# ----------------------------------------- post-processing and wideband


def _map_stack(seed, nf=64, nr=40, frames=24, targets=((30, 12), (12, 40))):
    """A (doppler, range, frames) stack of noise with fixed point targets
    at (range row, Doppler row) cells, strong enough to be tracked."""
    rng = np.random.default_rng(seed)
    x = (rng.random((nf, nr, frames)) * 0.2 + 1.0).astype(np.float32)
    for r, d in targets:
        x[d, r, :] = 60.0
    return x


@pytest.mark.cuda
def test_cfar_stack_and_display_card_match_cpu(cuda):
    """cfar_stack, persistence_stack and the streamed display frames on the
    card against the CPU: rtol 1e-5 for CFAR (sums in another order), 1e-6
    for persistence (the same multiply-adds)."""
    from passiveradar_torch.cli.plot import LazyCFAR, cfar_stack
    from passiveradar_torch.viz import persistence_stack
    from passiveradar_torch.viz.render import (iter_display_frames,
                                               prepare_display_frames)
    x = _map_stack(11)
    cf_card = cfar_stack(x, device=cuda)
    cf_cpu = cfar_stack(x, device="cpu")
    np.testing.assert_allclose(cf_card, cf_cpu, rtol=1e-5)
    frames = torch.from_numpy(np.moveaxis(cf_cpu, 2, 0).copy())
    got = persistence_stack(frames.to(cuda), 20, 0.9).cpu().numpy()
    want = persistence_stack(frames, 20, 0.9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    shown = np.stack(list(iter_display_frames(LazyCFAR(x, device=cuda),
                                              chunk=5, device=cuda)))
    np.testing.assert_allclose(
        shown, prepare_display_frames(cf_cpu, device="cpu"), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
def test_batch_trackers_card_match_cpu(cuda, strict):
    """Both batch trackers on the card against the CPU on the same CFAR
    stack: statuses, lifetimes, histories, lock modes and measured cells
    equal; estimates within 1e-3."""
    from passiveradar_torch.cli.plot import cfar_stack
    from passiveradar_torch.detect.trackers import (multitarget_tracker,
                                                    simple_target_tracker,
                                                    to_host)
    cf = cfar_stack(_map_stack(12), device="cpu")
    kw = dict(frames_last=True)
    got = to_host(multitarget_tracker(cf, (32.0, 100.0), 6, 64, device=cuda,
                                      **kw))
    want = to_host(multitarget_tracker(cf, (32.0, 100.0), 6, 64,
                                       device="cpu", **kw))
    for k in ("status", "lifetime", "history"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["estimate"], want["estimate"], atol=1e-3)
    assert (got["status"][-1] == 2).sum() >= 2
    got = to_host(simple_target_tracker(cf, 100.0, 32.0, strict=strict,
                                        device=cuda, **kw))
    want = to_host(simple_target_tracker(cf, 100.0, 32.0, strict=strict,
                                         device="cpu", **kw))
    for k in ("lock_mode", "meas_idx"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["estimate"], want["estimate"], atol=1e-3)


@pytest.mark.cuda
def test_wideband_cpi_card_matches_cpu(cuda):
    """One wideband CPI (4 channels of 16,384 Hz, a station in channels 1
    and 2, one echo) on the card against the CPU: the argmax cell equal in
    each channel, maps within 2e-4 of the peak (the LS canceller's float32
    conditioning, ROADMAP §C)."""
    from passiveradar_torch.io.synthetic import wideband_capture_arrays
    from passiveradar_torch.wideband import wideband_frames
    cfg = derive_config(dict(
        input_sample_rate=65536, input_center_freq=0, channel_freq=0,
        channel_bandwidth=65536, cpi_seconds_nominal=0.25,
        max_doppler_nominal=128.0, max_range_nominal=600.0,
        wideband_channels=4, wideband_channel_select=(1, 2)))
    ref, srv = wideband_capture_arrays(cfg, 1, delay_samples=48,
                                       doppler_hz=40.0, seed=3)
    ref = ref.view(np.complex64)[None]
    srv = srv.view(np.complex64)[None]
    got = wideband_frames(ref, srv, cfg, device=cuda).cpu().numpy()
    want = wideband_frames(ref, srv, cfg, device="cpu").numpy()
    for i in range(2):
        g, w = np.abs(got[0, i]), np.abs(want[0, i])
        assert np.unravel_index(np.argmax(g), g.shape) == \
            np.unravel_index(np.argmax(w), w.shape)
        assert np.max(np.abs(got[0, i] - want[0, i])) <= 2e-4 * np.max(w)


_IMPLS = ("carry", "coupled", "segment")
_SOLVERS = ("levinson", "gs_matrix", "gs_dense", "cholesky")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("solver", _SOLVERS)
def test_ls_filter_multiple_impls_card_match_cpu(cuda, impl, solver):
    """Every impl with every solver on the card against the CPU, on white
    noise with an echo (well conditioned: 1e-4 of the peak |srv|), with an
    all-zero frame in the batch that stays finite zeros."""
    rng = np.random.default_rng(5)
    n, flen, fs = 4096, 16, 4096 / 0.9998442
    ref = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
           ).astype(np.complex64)
    srv = (np.roll(ref, 2, axis=-1) + 0.05 * (
        rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    ).astype(np.complex64)
    ref[1] = srv[1] = 0
    bins = (0, 1, -1, 2, -2)
    got = ls_filter_multiple(torch.from_numpy(ref).to(cuda),
                             torch.from_numpy(srv).to(cuda), flen, fs, bins,
                             solver=solver, impl=impl).cpu().numpy()
    want = ls_filter_multiple(torch.from_numpy(ref), torch.from_numpy(srv),
                              flen, fs, bins, solver=solver,
                              impl=impl).numpy()
    assert np.all(np.isfinite(got)) and np.max(np.abs(got[1])) == 0.0
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(srv))


@pytest.mark.cuda
def test_flattop_caf_card_matches_cpu(cuda):
    """The flattop CAF on the card against the CPU, windowed, batched."""
    rng = np.random.default_rng(6)
    ref = (rng.standard_normal((2, 8192)) + 1j * rng.standard_normal(
        (2, 8192))).astype(np.complex64)
    srv = (rng.standard_normal((2, 8192)) + 1j * rng.standard_normal(
        (2, 8192))).astype(np.complex64)
    from passiveradar_torch.ops.caf import fast_xambg
    args = (40, 64)
    kw = dict(window=("kaiser", 5.0), short_filt=False)
    got = fast_xambg(torch.from_numpy(ref).to(cuda),
                     torch.from_numpy(srv).to(cuda), *args, **kw).cpu().numpy()
    want = fast_xambg(torch.from_numpy(ref), torch.from_numpy(srv), *args,
                      **kw).numpy()
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


@pytest.mark.cuda
def test_single_bin_cancellers_and_ops_card_match_cpu(cuda):
    """ls_filter, ls_filter_svd, ls_filter_toeplitz, gal_jpe, direct_xambg,
    decimate_taps, offset_compensation and channel_preprocessing on numpy
    input: the card by default, the CPU with device='cpu'."""
    from passiveradar_torch import ops
    rng = np.random.default_rng(7)
    ref = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
           ).astype(np.complex64)
    srv = (0.8 * np.roll(ref, 3) + 0.1 * (rng.standard_normal(1024) + 1j
                                          * rng.standard_normal(1024))
           ).astype(np.complex64)
    raw = (1000 * rng.standard_normal(4096)).astype(np.int16)
    calls = {
        "ls_filter": lambda **kw: ops.ls_filter(ref, srv, 12, **kw),
        "ls_filter_svd": lambda **kw: ops.ls_filter_svd(ref, srv, 10, **kw),
        "ls_filter_toeplitz": lambda **kw: ops.ls_filter_toeplitz(
            ref, srv, 24, **kw),
        "gal_jpe": lambda **kw: ops.gal_jpe(ref[:200], srv[:200], 4, 8, 1e-3,
                                            1e-2, **kw),
        "direct_xambg": lambda **kw: ops.direct_xambg(ref, srv, 10, 16,
                                                      1024.0, **kw),
        "decimate_taps": lambda **kw: ops.decimate_taps(ref, np.ones(17), 16,
                                                        **kw),
        "offset_compensation": lambda **kw: ops.offset_compensation(
            ref, np.roll(ref, 5), 1024, 1, 16, **kw),
        "channel_preprocessing": lambda **kw: ops.channel_preprocessing(
            raw, 4, 100.0, 4096.0, **kw),
    }
    for name, call in calls.items():
        got = call()
        assert got.device.type == "cuda", name
        want = call(device="cpu").numpy()
        got = got.cpu().numpy()
        assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want)), name


@pytest.mark.cuda
@pytest.mark.parametrize("impl,launches", [("coupled", 3), ("segment", 0)])
def test_ls_filter_impls_fused_route_launches(cuda, monkeypatch, impl,
                                              launches):
    """Under the fused-FFT opt-in, 'coupled' sends its three full-length
    transforms (the reference spectra, srv's, the final inverse) to the
    kernel, and 'segment' none (its transforms are 4,096 points); both stay
    within 2e-4 of the cuFFT route."""
    n = 65536
    gen = torch.Generator(device=cuda).manual_seed(6)
    ref = torch.randn((2, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    srv = 0.3 * torch.roll(ref, 7, dims=1) + 0.1 * torch.randn(
        (2, n), dtype=torch.complex64, generator=gen, device=cuda)
    bins = (0.0, 1.0, -1.0, 2.0, -2.0)
    monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)
    want = ls_filter_multiple(ref, srv, 22, float(n), bins, impl=impl)
    monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    before = fk.fft_fused.launches
    got = ls_filter_multiple(ref, srv, 22, float(n), bins, impl=impl)
    torch.cuda.synchronize()
    assert fk.fft_fused.launches == before + launches
    assert (got - want).abs().max().item() < 2e-4


def _tiny_frames(nfr, **over):
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0,
                             max_doppler_nominal=128.0,
                             max_range_nominal=400.0, **over))
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    length = cfg.input_chunk_length
    return (cfg, ref[:nfr * length].reshape(nfr, length),
            srv[:nfr * length].reshape(nfr, length),
            frame_phases(cfg, list(range(nfr))))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ls_multiple", "nlms_pallas"])
def test_process_frames_shmap_on_one_card_matches_process_frames(cuda,
                                                                 method):
    """Two shards on the one card: blocks on the card, each shard's
    preprocess through the resampler kernel (2 launches a shard) and, under
    nlms_pallas, the NLMS kernel (1 a shard); 4 halo exchanges; maps within
    1e-4 of process_frames on the card."""
    from passiveradar_torch.parallel.halo import local_overlap
    from passiveradar_torch.parallel.mesh import make_mesh
    from passiveradar_torch.pipeline import process_frames_shmap
    cfg, ref, srv, ph = _tiny_frames(4, clutter_method=method)
    mesh = make_mesh(devices=[cuda, cuda])
    want = process_frames(ref, srv, ph, cfg, device=cuda).cpu().numpy()
    b1, b2, ex = (rk.mix_regroup_matmul.launches, nk.nlms_filter_batch.launches,
                  local_overlap.exchanges)
    blocks = process_frames_shmap(ref, srv, ph, cfg, mesh)
    torch.cuda.synchronize()
    assert [b.device for b in blocks] == [cuda, cuda]
    assert rk.mix_regroup_matmul.launches - b1 == 4
    assert nk.nlms_filter_batch.launches - b2 == (
        2 if method == "nlms_pallas" else 0)
    assert local_overlap.exchanges - ex == 4
    got = torch.cat(blocks).cpu().numpy()
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))


@pytest.mark.cuda
def test_process_frames_groups_card_matches_loop(cuda):
    """Two groups of 3 frames on the card: each group exactly its own
    process_frames call, 2 resampler launches a group."""
    from passiveradar_torch.pipeline import process_frames_groups
    cfg, ref, srv, _ = _tiny_frames(6)
    refs, srvs = ref.reshape(2, 3, -1), srv.reshape(2, 3, -1)
    phs = np.stack([frame_phases(cfg, [0, 1, 2]),
                    frame_phases(cfg, [3, 4, 5])])
    before = rk.mix_regroup_matmul.launches
    got = process_frames_groups(refs, srvs, phs, cfg).cpu().numpy()
    assert rk.mix_regroup_matmul.launches - before == 4
    for g in range(2):
        loop = process_frames(refs[g], srvs[g], phs[g], cfg).cpu().numpy()
        np.testing.assert_array_equal(got[g], loop)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_fast_xambg_tp_on_one_card_matches_fast_xambg(cuda, n):
    from passiveradar_torch.ops.caf import fast_xambg, fast_xambg_tp
    from passiveradar_torch.parallel.mesh import make_mesh
    gen = torch.Generator(device=cuda).manual_seed(n)
    ref = torch.randn(8192, dtype=torch.complex64, generator=gen, device=cuda)
    srv = torch.randn(8192, dtype=torch.complex64, generator=gen, device=cuda)
    want = fast_xambg(ref, srv, 15, 128, window=("kaiser", 5.0))
    blocks = fast_xambg_tp(ref, srv, 15, 128,
                           make_mesh(devices=[cuda] * n, axis_name="tp"),
                           window=("kaiser", 5.0))
    got = torch.cat(blocks, dim=1)
    assert (got - want).abs().max().item() < 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_wideband_frames_shmap_on_one_card_matches_wideband_frames(cuda):
    from passiveradar_torch.io.synthetic import wideband_capture_arrays
    from passiveradar_torch.parallel.mesh import make_mesh
    from passiveradar_torch.wideband import wideband_frames, \
        wideband_frames_shmap
    cfg = derive_config(dict(
        input_sample_rate=65536, input_center_freq=0, channel_freq=0,
        channel_bandwidth=65536, cpi_seconds_nominal=0.25,
        max_doppler_nominal=128.0, max_range_nominal=600.0,
        wideband_channels=4, wideband_channel_select=(1, 2)))
    ref, srv = wideband_capture_arrays(cfg, 2, delay_samples=48,
                                       doppler_hz=40.0, seed=3)
    n = cfg.cpi_samples * cfg.wideband_channels
    ref = ref.view(np.complex64)[:2 * n].reshape(2, n)
    srv = srv.view(np.complex64)[:2 * n].reshape(2, n)
    want = wideband_frames(ref, srv, cfg, device=cuda)
    blocks = wideband_frames_shmap(
        ref, srv, cfg, make_mesh(devices=[cuda, cuda], axis_name="channels"))
    got = torch.cat(blocks, dim=1)
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_synth_capture_device_on_the_card(cuda):
    """The device generator on the card: the same seed gives the same
    samples on every run, the two output forms are one stream, and the
    scene's levels hold (tests/test_torch_synthetic_device.py on the CPU)."""
    from passiveradar_torch.io.synthetic import synth_capture_device
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0))
    targets = (Target(40, 20.0, 0.1),)
    runs = [synth_capture_device(cfg, 6, targets=targets, seed=2,
                                 complex_output=True, device=cuda)
            for _ in range(2)]
    ref, srv = synth_capture_device(cfg, 6, targets=targets, seed=2,
                                    device=cuda)
    for (cr, cs), other in zip(runs, runs[::-1]):
        assert torch.equal(cr, other[0]) and torch.equal(cs, other[1])
    assert torch.equal(torch.view_as_real(runs[0][0]).reshape(ref.shape), ref)
    assert torch.equal(torch.view_as_real(runs[0][1]).reshape(srv.shape), srv)
    assert abs(runs[0][0].abs().mean().item() - 1) < 1e-2
    assert abs((runs[0][1].abs() ** 2).mean().item() / 0.26 - 1) < 0.05


# ------------------------------------------------- the tracker step kernel

def _tracker_scene(seed, channels, frames, nf=128, nr=201):
    """(channels, frames, nf, nr) maps at the wideband stream's geometry:
    noise and, in each channel, three point targets drifting in Doppler,
    the last of them gone after half the frames (its track coasts)."""
    rng = np.random.default_rng(seed)
    x = (rng.random((channels, frames, nf, nr)) * 0.2 + 1.0).astype(
        np.float32)
    for c in range(channels):
        for t in range(frames):
            for j in range(3 if t < frames // 2 else 2):
                x[c, t, 20 + 30 * j + 2 * c + t // 4, 40 + 45 * j + 5 * c] = \
                    60.0 - 10 * j
    return x


def _assert_tracker_tables(got, want):
    """tests/test_torch_detect.py's tolerances: the discrete state equal,
    estimates and measurements within atol 1e-4, the filter within atol
    1e-4, rtol 1e-5."""
    for k in ("status", "lifetime", "history"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("estimate", "measurement"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-6,
                                   err_msg=k)
    for k in ("x", "P", "S"):
        np.testing.assert_allclose(got["kalman"][k], want["kalman"][k],
                                   atol=1e-4, rtol=1e-5, err_msg=k)
    for k in ("F1", "F2", "Q", "H", "R"):
        np.testing.assert_array_equal(got["kalman"][k], want["kalman"][k])


@pytest.mark.cuda
@pytest.mark.parametrize("channels,frames", [(1, 1), (1, 16), (8, 1),
                                             (8, 16)])
def test_tracker_kernel_matches_plain(cuda, channels, frames):
    """The tracker kernel against its plain version on the same card
    candidates, 10 tracks, K = 384: from free tables over 16 frames, or one
    frame from the tables that 8 plain frames left (live tracks)."""
    from passiveradar_torch.detect import tracker_kernel as trk
    from passiveradar_torch.detect import trackers as tt
    from passiveradar_torch.detect.measurements import get_measurements
    lead = 8 if frames == 1 else 0
    stack = torch.from_numpy(_tracker_scene(channels, channels,
                                            lead + frames)).to(cuda)
    extent = torch.tensor((256.0, 60.0), device=cuda)
    cand, valid = get_measurements(stack, extent, 384)
    table = tt.init_tracks(10, cuda, channels)
    if lead:
        table = tt._map(lambda a: a[-1].contiguous(),
                        tt.multitarget_step_plain(table, cand[:, :lead],
                                                  valid[:, :lead], 10))
    cand = cand[:, lead:].contiguous()
    valid = valid[:, lead:].contiguous()
    before = trk.multitarget_step_kernel.launches
    got = tt.to_host(trk.multitarget_step_kernel(table, cand, valid, 10))
    assert trk.multitarget_step_kernel.launches == before + 1
    want = tt.to_host(tt.multitarget_step_plain(table, cand, valid, 10))
    torch.cuda.synchronize()
    assert got["status"].shape == (frames, channels, 10)
    _assert_tracker_tables(got, want)
    assert (want["status"] > 0).any()


def _scene_table(statuses, rng, points):
    """One channel's (N, …) table with the given statuses: a free slot as
    init_tracks makes it; a live slot at one of ``points`` (its
    measurement), its estimate a little off, a random history and
    lifetime, and a non-diagonal S."""
    from passiveradar_torch.detect import trackers as tt
    slots = []
    for i, st in enumerate(statuses):
        if st == 0:
            slots.append(tt.make_track(None, "cpu"))
            continue
        p = np.asarray(points[i % len(points)], np.float32)
        tr = tt.make_track(torch.from_numpy(p), "cpu")
        tr["status"] = torch.tensor(st, dtype=torch.int32)
        tr["lifetime"] = torch.tensor(int(rng.integers(1, 12)),
                                      dtype=torch.int32)
        tr["estimate"] = torch.from_numpy(
            (p + rng.normal(0, 1.0, 2)).astype(np.float32))
        tr["history"] = torch.from_numpy(
            (rng.random(20) < 0.6).astype(np.float32))
        a, b, c = rng.uniform(1, 6), rng.uniform(-0.8, 0.8), \
            rng.uniform(1, 9)
        tr["kalman"]["S"] = torch.tensor([[a, b], [b, c]],
                                         dtype=torch.float32)
        slots.append(tr)
    return tt._stack(slots)


def _scene_candidates(rng, k, points, spread=3.0):
    """(3, k) float32 candidates: half in clusters around ``points``, the
    rest over the map (range 0…60 km, Doppler ±30 Hz), strengths
    decreasing."""
    near = rng.integers(0, len(points), k // 2)
    pts = np.asarray(points, np.float32)[near] + rng.normal(
        0, spread, (k // 2, 2))
    far = np.stack([rng.uniform(0, 60, k - k // 2),
                    rng.uniform(-30, 30, k - k // 2)], 1)
    xy = np.concatenate([pts, far])[rng.permutation(k)]
    strength = np.sort(rng.random(k))[::-1]
    return np.stack([xy[:, 0], xy[:, 1], strength]).astype(np.float32)


ASSOCIATION_SCENES = ("k20", "k75", "all_invalid", "ties", "one_candidate",
                      "status_mixes", "c8_t16")


@functools.cache
def _association_scenes() -> dict:
    """The tracker step's association cases by name, each (table (C, N, …),
    cand (C, T, 3, K), valid (C, T, K), N) on the CPU, made with numpy from
    a seed: K < 32; K not a multiple of 32; every candidate invalid;
    distance ties in a preliminary gate (four candidates at distance 5 from
    the origin, in four lanes, one of them in its lane's second word, and
    none nearer); a free slot with exactly one candidate; every mix of
    three statuses (27 channels); and 8 channels over 16 frames of CFAR
    maps (K = 300)."""
    from passiveradar_torch.detect import trackers as tt
    from passiveradar_torch.detect.measurements import get_measurements
    rng = np.random.default_rng(2024)
    points = [(12.0, 5.0), (30.0, -8.0), (45.0, 14.0)]
    scenes = {}

    def one_frame(name, tables, cands, valids, n):
        scenes[name] = (tt._stack(tables),
                        torch.from_numpy(np.stack(cands)[:, None].copy()),
                        torch.from_numpy(np.stack(valids)[:, None].copy()),
                        n)

    for k in (20, 75):
        one_frame(f"k{k}", [_scene_table((2, 1, 0, 2, 1, 0), rng, points)],
                  [_scene_candidates(rng, k, points)],
                  [rng.random(k) < 0.85], 6)
    one_frame("all_invalid",
              [_scene_table((2, 1, 0, 1, 0, 0), rng, points)],
              [_scene_candidates(rng, 40, points)], [np.zeros(40, bool)], 6)
    cand = _scene_candidates(rng, 64, [(40.0, -20.0)])
    near = np.hypot(cand[0], cand[1]) < 8
    cand[0, near] += 20                   # nothing else near the origin
    for idx, (r, d) in {2: (5, 0), 33: (4, 3), 8: (3, 4), 40: (0, 5),
                        0: (6, 6), 20: (7.5, 1)}.items():
        cand[:2, idx] = (r, d)
    one_frame("ties", [_scene_table((1, 0, 0, 2), rng,
                                    [(3.5, 3.5), (40.0, -20.0)])],
              [cand], [np.ones(64, bool)], 4)
    valid = np.zeros(50, bool)
    valid[17] = True
    one_frame("one_candidate", [_scene_table((0, 0, 0, 0), rng, points)],
              [_scene_candidates(rng, 50, points)], [valid], 4)
    mixes = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]
    one_frame("status_mixes", [_scene_table(m, rng, points) for m in mixes],
              [_scene_candidates(rng, 48, points) for _ in mixes],
              [rng.random(48) < 0.9 for _ in mixes], 3)
    maps = torch.from_numpy(_tracker_scene(7, 8, 16))
    cand, valid = get_measurements(maps, torch.tensor((256.0, 60.0)), 300)
    scenes["c8_t16"] = (tt.init_tracks(10, "cpu", 8), cand.contiguous(),
                        valid.contiguous(), 10)
    return scenes


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ASSOCIATION_SCENES)
def test_tracker_kernel_association_scenes(cuda, scene):
    """The tracker kernel against its plain version on the same card
    tensors for each association case of tests/test_torch_tracker_step.py:
    the discrete state equal, the floats within tests/test_torch_detect.py's
    tolerances (chip_smoke.py TRACKER_TOL)."""
    from passiveradar_torch.detect import tracker_kernel as trk
    from passiveradar_torch.detect import trackers as tt
    table, cand, valid, n = _association_scenes()[scene]
    table = tt._map(lambda a: a.to(cuda), table)
    cand, valid = cand.to(cuda), valid.to(cuda)
    before = trk.multitarget_step_kernel.launches
    got = tt.to_host(trk.multitarget_step_kernel(table, cand, valid, n))
    assert trk.multitarget_step_kernel.launches == before + 1
    want = tt.to_host(tt.multitarget_step_plain(table, cand, valid, n))
    torch.cuda.synchronize()
    _assert_tracker_tables(got, want)


@pytest.mark.cuda
def test_tracker_step_makes_no_host_sync(cuda):
    """multitarget_step on the card (the batched candidates and one kernel
    launch) for 8 channels and for one: no host synchronisation, one
    launch a call, the input table left as it was."""
    from passiveradar_torch.detect import tracker_kernel as trk
    from passiveradar_torch.detect import trackers as tt
    stack = torch.from_numpy(_tracker_scene(5, 8, 1)[:, 0]).to(cuda)
    extent = torch.tensor((256.0, 60.0), device=cuda)
    table = tt.init_tracks(10, cuda, 8)
    one = tt.init_tracks(10, cuda)
    tt.multitarget_step(table, stack, extent, 10, 384)     # load and warm
    before = trk.multitarget_step_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tt.multitarget_step(table, stack, extent, 10, 384)
        got_one = tt.multitarget_step(one, stack[3], extent, 10, 384)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trk.multitarget_step_kernel.launches == before + 2
    assert got["status"].shape == (8, 10) and got_one["status"].shape == (10,)
    _assert_tracker_tables(tt.to_host(tt._slot(got, 3)), tt.to_host(got_one))
    assert (tt.to_host(table)["status"] == 0).all()


def _tracker_limit_inputs(rng, k, n, frames, dev):
    """One channel's free table of n slots and ``frames`` frames of k
    _scene_candidates, 90% of them valid, on ``dev``."""
    from passiveradar_torch.detect import trackers as tt
    points = [(12.0, 5.0), (30.0, -8.0), (45.0, 14.0)]
    cand = np.stack([_scene_candidates(rng, k, points)
                     for _ in range(frames)])[None]
    valid = rng.random((1, frames, k)) < 0.9
    return (tt.init_tracks(n, dev, 1), torch.from_numpy(cand.copy()).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fm_candidates", "ten_slots"])
def test_tracker_kernel_at_its_shared_memory_limit(cuda, case):
    """The largest launch the card's shared memory holds: at K = 540 (the
    FM stream's candidates) the most slots, at 10 slots the most
    candidates (tracker_kernel.shared_memory_limits). Over
    two frames from free tables the kernel equals its plain version; one
    slot or candidate more raises ValueError, naming the limits, and
    launches nothing."""
    from passiveradar_torch.detect import tracker_kernel as trk
    from passiveradar_torch.detect import trackers as tt
    lim = trk.shared_memory_limits(540, 10, cuda.index)
    if case == "fm_candidates":
        k, n = 540, lim["most_tracks"]
        over = (k, n + 1)
    else:
        k, n = lim["most_k"], 10
        over = (k + 1, n)
    assert n >= 10 and k >= 540
    rng = np.random.default_rng(k + n)
    table, cand, valid = _tracker_limit_inputs(rng, k, n, 2, cuda)
    got = tt.to_host(trk.multitarget_step_kernel(table, cand, valid, n))
    want = tt.to_host(tt.multitarget_step_plain(table, cand, valid, n))
    _assert_tracker_tables(got, want)
    assert (got["status"][1] != 0).any()
    table, cand, valid = _tracker_limit_inputs(rng, *over, 1, cuda)
    before = trk.multitarget_step_kernel.launches
    with pytest.raises(ValueError, match="at most"):
        trk.multitarget_step_kernel(table, cand, valid, over[1])
    assert trk.multitarget_step_kernel.launches == before


def _autocorr_systems(rng, systems, m, n=4096):
    """(systems, m) complex64 first columns: autocorrelation lags of noise
    plus a delayed copy, the first system all zero after the stage's
    guard (c[0] = 1e-25)."""
    out = np.zeros((systems, m), np.complex64)
    for b in range(1, systems):
        s = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        s = s + 0.5 * np.roll(s, 1 + b % 40)
        spec = np.fft.fft(s, 2 * n)
        out[b] = np.fft.ifft(spec * spec.conj())[:m]
    out[0, 0] = np.float32(1e-25)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 33, 185, 210, 360, 600])
def test_levinson_kernel_matches_plain(cuda, m):
    """The Levinson kernel against its plain loop on the same card
    tensors: m = 185 (FM), 210 (the wideband band), 360 (bench_scaling's
    400 km), 33, 1, and 600 (a in shared memory); 50 systems, one of them
    the guarded zero system, at tests/test_torch_ops.py's 1e-4."""
    from passiveradar_torch.ops import levinson_kernel as lk
    c = torch.from_numpy(_autocorr_systems(np.random.default_rng(m), 50,
                                           m)).to(cuda)
    before = lk.levinson_first_col_kernel.launches
    got = lk.levinson_first_col_kernel(c)
    assert lk.levinson_first_col_kernel.launches == before + 1
    want = lk.levinson_first_col_plain(c)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(got)).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()
    assert (got[1:] - want[1:]).abs().max().item() <= \
        1e-4 * want[1:].abs().max().item()
    assert got[0, 0].real.item() == want[0, 0].real.item()


@pytest.mark.cuda
def test_levinson_kernel_refuses_above_its_order(cuda):
    """An order above what one warp's shared memory holds raises
    ValueError naming the limit, and launches nothing."""
    from passiveradar_torch.ops import levinson_kernel as lk
    c = torch.zeros((2, lk.MAX_ORDER + 1), dtype=torch.complex64,
                    device=cuda)
    before = lk.levinson_first_col_kernel.launches
    with pytest.raises(ValueError, match=str(lk.MAX_ORDER)):
        lk.levinson_first_col_kernel(c)
    assert lk.levinson_first_col_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("solver", _SOLVERS)
def test_graphed_stage_matches_eager(cuda, impl, solver):
    """The graphed LS stage on the card against the eager one, on the
    inputs of test_ls_filter_multiple_impls_card_match_cpu with its zero
    frame: the first call (warm-up, then capture) and two replays bit-equal
    to the eager stage; the Levinson kernel's counter counts each replay's
    launch."""
    from passiveradar_torch.ops import graphs
    from passiveradar_torch.ops import levinson_kernel as lk
    rng = np.random.default_rng(5)
    n, flen, fs = 4096, 16, 4096 / 0.9998442
    ref = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
           ).astype(np.complex64)
    srv = (np.roll(ref, 2, axis=-1) + 0.05 * (
        rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    ).astype(np.complex64)
    ref[1] = srv[1] = 0
    bins = (0, 1, -1, 2, -2)
    r = torch.from_numpy(ref).to(cuda)
    s = torch.from_numpy(srv).to(cuda)
    want = ls_filter_multiple(r, s, flen, fs, bins, solver=solver,
                              impl=impl)
    per_call = 0 if solver == "cholesky" else 1
    graphed = [ls_filter_multiple_graphed(r, s, flen, fs, bins,
                                          solver=solver, impl=impl)]
    before = lk.levinson_first_col_kernel.launches
    for _ in range(2):
        graphed.append(ls_filter_multiple_graphed(r, s, flen, fs, bins,
                                                  solver=solver, impl=impl))
    torch.cuda.synchronize()
    assert lk.levinson_first_col_kernel.launches == before + 2 * per_call
    entry = graphs.lookup(graphs.graph_key(
        "clutter", (r, s), (flen, fs, bins, impl, solver)), cuda)
    assert entry.replays >= 2
    assert entry.launches.get("levinson_first_col", 0) == per_call
    for got in graphed:
        assert torch.equal(got, want)
    assert graphed[1].data_ptr() != graphed[2].data_ptr()


@pytest.mark.cuda
def test_graphed_stage_replays_without_host_sync(cuda):
    """Once captured, the FM-shaped stage (carry, levinson; 2 frames of
    2^16 samples) replays under torch.cuda.set_sync_debug_mode("error"),
    as the eager stage runs there once its tables are made; the replay
    equals the eager result."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    n = 65536
    ref = torch.randn((2, n), dtype=torch.complex64, generator=gen,
                      device=cuda)
    srv = 0.3 * torch.roll(ref, 7, dims=1) + 0.1 * torch.randn(
        (2, n), dtype=torch.complex64, generator=gen, device=cuda)
    args = (ref, srv, 175, float(n) / 1.0, (0, 1, -1, 2, -2))
    ls_filter_multiple_graphed(*args)                 # warm-up and capture
    eager = ls_filter_multiple(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ls_filter_multiple(*args)
        got = ls_filter_multiple_graphed(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, eager) and torch.equal(again, eager)


# ------------------------------------------ the entry points' CUDA graphs

def _bits(x):
    """The tensor's bits: NaN frames compare equal to themselves."""
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.contiguous().view(torch.int32)


def _graph_batch(cuda, dtype="float32", nfr=4, **over):
    """A batch at a geometry whose LS transforms reach the fused FFT's
    lengths (65,536-sample CPIs): raw IQ pairs (int16 or float32) with a
    zero margin frame first, and phases, on the card."""
    params = dict(input_sample_rate=49152, input_center_freq=1_000_000,
                  channel_freq=990_170, channel_bandwidth=12800,
                  cpi_seconds_nominal=8.0, max_doppler_nominal=128.0,
                  max_range_nominal=400.0)
    if dtype == "int16":
        params["int16_scale"] = 1.0 / 4096
    cfg = derive_config(dict(params, **over))
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    n = cfg.input_chunk_length
    shape = (nfr, n // 2, 2)
    ref, srv = ref[:nfr * n].reshape(shape), srv[:nfr * n].reshape(shape)
    if dtype == "int16":
        ref = np.round(ref * 4096).astype(np.int16)
        srv = np.round(srv * 4096).astype(np.int16)
    ref[0] = srv[0] = 0
    ph = frame_phases(cfg, list(range(nfr)))
    return (cfg, torch.from_numpy(ref).to(cuda), torch.from_numpy(srv).to(cuda),
            torch.from_numpy(ph).to(cuda))


def _fused_env(monkeypatch, fused):
    if fused:
        monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    else:
        monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)


def _assert_replays_equal_eager(cuda, kind, fn, eager, inputs, cfg):
    """fn() three times (warm-up and capture, then two replays), each
    bit-equal to ``eager``; the graph kept under its key replayed twice."""
    from passiveradar_torch.ops import graphs
    outs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    entry = graphs.lookup(graphs.graph_key(kind, inputs, cfg), cuda)
    assert entry is not None and entry.replays >= 2
    for out in outs:
        for got, want in zip(graphs._tensors(out), graphs._tensors(eager)):
            assert torch.equal(_bits(got), _bits(want))
    return entry


_BATCH_CASES = [("ls_multiple", dt, fused, sf) for dt in ("int16", "float32")
                for fused in (False, True) for sf in (True, False)] + [
    (m, dt, False, sf) for m in ("nlms", "nlms_pallas", "none")
    for dt in ("int16", "float32") for sf in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("method,dtype,fused,short_filt", _BATCH_CASES)
def test_batch_graph_matches_eager(cuda, monkeypatch, method, dtype, fused,
                                   short_filt):
    """process_frames as a replayed batch graph against the eager chain on
    the same card, bit for bit (the NaN frames of 'nlms' included), for
    every clutter_method, raw dtype, FFT route and CAF decimator; the
    launches of a replay are those of the eager chain."""
    from passiveradar_torch import pipeline as pl
    _fused_env(monkeypatch, fused)
    cfg, ref, srv, ph = _graph_batch(cuda, dtype, clutter_method=method,
                                     caf_short_filt=short_filt)
    eager = pl._process_frames_impl(ref, srv, ph, cfg)
    entry = _assert_replays_equal_eager(
        cuda, "frames", lambda: pl.process_frames(ref, srv, ph, cfg), eager,
        (ref, srv, ph), cfg)
    assert entry.launches.get("mix_regroup_matmul") == 2
    assert entry.launches.get("nlms_filter_pallas", 0) == (
        1 if method.startswith("nlms") else 0)
    assert entry.launches.get("levinson_first_col", 0) == (
        1 if method == "ls_multiple" else 0)
    assert (entry.launches.get("fft_fused", 0) > 0) == (
        fused and method == "ls_multiple")
    if method == "nlms":
        assert torch.isnan(eager[0]).all()


@pytest.mark.cuda
def test_batch_graph_counts_the_nlms_frames_it_filters(cuda):
    """``nlms_filter_batch.frames`` beside ``launches`` through the batch
    graph: each call of process_frames (the warm-up, then replays) adds
    one launch and the batch's frames."""
    from passiveradar_torch import pipeline as pl
    cfg, ref, srv, ph = _graph_batch(cuda, "int16",
                                     clutter_method="nlms_pallas")
    launches = nk.nlms_filter_batch.launches
    frames = nk.nlms_filter_batch.frames
    for i in range(1, 4):
        pl.process_frames(ref, srv, ph, cfg)
        assert (nk.nlms_filter_batch.launches - launches,
                nk.nlms_filter_batch.frames - frames) == (i, i * ref.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("solver", _SOLVERS)
def test_batch_graph_every_canceller_matches_eager(cuda, impl, solver):
    """Every clutter_impl × clutter_solver captured inside the batch graph
    (the LS stage eager there), each replay bit-equal to the eager chain."""
    from passiveradar_torch import pipeline as pl
    cfg, ref, srv, ph = _graph_batch(cuda, nfr=3, clutter_impl=impl,
                                     clutter_solver=solver)
    eager = pl._process_frames_impl(ref, srv, ph, cfg)
    _assert_replays_equal_eager(
        cuda, "frames", lambda: pl.process_frames(ref, srv, ph, cfg), eager,
        (ref, srv, ph), cfg)


@pytest.mark.cuda
def test_batch_graph_keeps_no_clutter_graph(cuda, monkeypatch):
    """A frames graph's first call reaches the graphed LS stage while the
    graph is built (warm-up and capture): the stage runs eagerly there, so
    the cache keeps the frames graph alone, which holds the Levinson
    kernel's launch."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import graphs
    monkeypatch.setattr(graphs, "_graphs", {})
    cfg, ref, srv, ph = _graph_batch(cuda, nfr=3)
    pl.process_frames(ref, srv, ph, cfg)
    torch.cuda.synchronize()
    kept = graphs.cache_info()
    assert [g["kind"] for g in kept] == ["frames"]
    assert kept[0]["launches"].get("levinson_first_col") == 1


@pytest.mark.cuda
def test_stage_entry_points_replay_graphs(cuda):
    """preprocess_batch, caf_batch, process_frames_groups and the stream's
    clean step each replay their own graph, bit-equal to their eager
    functions."""
    from passiveradar_torch import pipeline as pl
    cfg, ref, srv, ph = _graph_batch(cuda)
    r_if = pl._preprocess_impl(ref, ph, cfg)
    _assert_replays_equal_eager(
        cuda, "preprocess", lambda: pl.preprocess_batch(ref, ph, cfg), r_if,
        (ref, ph), cfg)
    clean = pl._clean_impl(ref, srv, ph, cfg)
    _assert_replays_equal_eager(
        cuda, "clean", lambda: pl._clean_batch(ref, srv, ph, cfg), clean,
        (ref, srv, ph), cfg)
    _assert_replays_equal_eager(
        cuda, "caf", lambda: pl.caf_batch(*clean, cfg),
        pl._caf_batch_impl(*clean, cfg), clean, cfg)
    refs, srvs, phs = (x.reshape(2, 2, *x.shape[1:]) for x in (ref, srv, ph))
    _assert_replays_equal_eager(
        cuda, "groups", lambda: pl.process_frames_groups(refs, srvs, phs, cfg),
        pl._process_groups_impl(refs, srvs, phs, cfg), (refs, srvs, phs),
        cfg)


@pytest.mark.cuda
def test_batch_graph_replays_without_host_sync(cuda):
    """Once captured, the batch graph replays under
    torch.cuda.set_sync_debug_mode("error"): no host sync in the copies,
    the replay or the clone; the replay equals the eager chain."""
    from passiveradar_torch import pipeline as pl
    cfg, ref, srv, ph = _graph_batch(cuda)
    pl.process_frames(ref, srv, ph, cfg)
    eager = pl._process_frames_impl(ref, srv, ph, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pl.process_frames(ref, srv, ph, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)


class _MemReader:
    """A capture in memory as run_capture reads it (read_pair_frames)."""

    def __init__(self, ref, srv):
        self.ref, self.srv = ref, srv
        self.num_frames = ref.shape[0]
        self.pair_dtype = ref.dtype

    def read_pair_frames(self, start, count):
        return self.ref[start:start + count], self.srv[start:start + count]


class _MemWriter:
    def __init__(self, shape):
        self.maps = np.zeros(shape, np.complex64)
        self.frames_done = 0

    def write(self, frames, start):
        self.maps[start:start + len(frames)] = frames

    def close(self):
        pass


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_run_capture_maps_equal_the_eager_chain(cuda, dtype):
    """run_capture on the card (7 frames in batches of 3: a capture, then
    replays fed from the pinned buffers) writes each batch's maps bit for
    bit as the eager chain gives them on the same buffers: frames written,
    one margin frame on each side, zero outside the capture."""
    from passiveradar_torch import pipeline as pl
    total, bf = 7, 3
    cfg, ref, srv, _ = _graph_batch(cuda, dtype, nfr=total, num_frames=total)
    ref, srv = ref.cpu().numpy(), srv.cpu().numpy()
    ref[0] = srv[0] = ref[1]                    # no zero frame here
    writer = _MemWriter((total, cfg.num_doppler_cells,
                         cfg.num_range_cells + 1))
    assert pl.run_capture(_MemReader(ref, srv), writer, cfg, batch_frames=bf,
                          progress=False, device=cuda) == total
    for start in range(0, total, bf):
        count = min(bf, total - start)
        slots = range(start - 1, start + bf + 1)
        buf = [np.stack([x[i] if 0 <= i < total else np.zeros_like(x[0])
                         for i in slots]) for x in (ref, srv)]
        ph = np.array([pl.frame_phases(cfg, [i])[0] if 0 <= i < total else 0
                       for i in slots], np.float32)
        want = pl._process_frames_impl(
            *(torch.from_numpy(b).to(cuda) for b in buf),
            torch.from_numpy(ph).to(cuda), cfg).cpu().numpy()
        np.testing.assert_array_equal(writer.maps[start:start + count],
                                      want[1:1 + count])


class _MemIQReader:
    """The same capture read as complex64 frames (read_iq_frames)."""

    def __init__(self, ref, srv):
        self.ref, self.srv = (x.view(np.complex64).reshape(x.shape[:2])
                              for x in (ref, srv))
        self.num_frames = ref.shape[0]

    def read_iq_frames(self, start, count):
        return self.ref[start:start + count], self.srv[start:start + count]


@pytest.mark.cuda
def test_run_wideband_capture_feed_maps_equal_the_eager_chain(cuda,
                                                              monkeypatch):
    """run_wideband_capture(integrate=True) on the card, 11 CPIs in batches
    of 4 (a short last batch), each CPI streamed through the feed's two
    pinned slots in chunks smaller than a CPI (so slots are refilled within
    a batch): each channel's maps and the integrated stack bit for bit as
    the eager wideband_frames gives them on the zero-padded numpy batches;
    the bytes and chunks sent are the plan's."""
    from passiveradar_torch import feed
    from passiveradar_torch.io import writers as tw
    from passiveradar_torch.wideband import run_wideband_capture, \
        wideband_frames
    chunk = (48 << 10) + 8
    monkeypatch.setattr(feed, "CHUNK_BYTES", chunk)
    total, bf = 11, 4
    cfg = derive_config(dict(
        input_sample_rate=65536, input_center_freq=0, channel_freq=0,
        channel_bandwidth=65536, cpi_seconds_nominal=0.25,
        max_doppler_nominal=128.0, max_range_nominal=600.0,
        wideband_channels=4, wideband_channel_select=(1, 2),
        num_frames=total))
    n = cfg.cpi_samples * cfg.wideband_channels
    rng = np.random.default_rng(11)
    raw = [rng.standard_normal((total, n, 2)).astype(np.float32)
           for _ in range(2)]
    shape = (total, cfg.num_doppler_cells, cfg.num_range_cells + 1)
    stacks = {k: _MemWriter(shape) for k in cfg.wideband_channel_select}
    made = []

    def mem_writer(*args, **kwargs):
        made.append(_MemWriter(shape))
        return made[-1]

    monkeypatch.setattr(tw, "MapWriter", mem_writer)
    counted = feed.stage_info()
    assert run_wideband_capture(
        _MemIQReader(*raw), cfg, batch_frames=bf, writers=stacks,
        progress=False, integrate=True, device=cuda) == total
    stats = {k: v - counted[k] for k, v in feed.stage_info().items()}
    counts = [min(bf, total - s) for s in range(0, total, bf)]
    cpi = n * 8
    assert stats["batches"] == len(counts)
    assert stats["frames_sent"] == 2 * total
    assert stats["bytes_sent"] == 2 * total * cpi
    assert stats["chunks"] == 2 * sum(-(-c * cpi // chunk) for c in counts)
    (integ,) = made
    for s, c in zip(range(0, total, bf), counts):
        bufs = [np.zeros((bf, n), np.complex64) for _ in range(2)]
        for buf, x in zip(bufs, raw):
            buf[:c] = x[s:s + c].view(np.complex64)[..., 0]
        want = wideband_frames(*bufs, cfg, device=cuda)[:c]
        for i, k in enumerate(cfg.wideband_channel_select):
            np.testing.assert_array_equal(stacks[k].maps[s:s + c],
                                          want[:, i].cpu().numpy())
        np.testing.assert_array_equal(
            integ.maps[s:s + c],
            want.abs().sum(dim=1).cpu().numpy().astype(np.complex64))


def _frames_graphs():
    from passiveradar_torch.ops import graphs
    kept = [g for g in graphs.cache_info() if g["kind"] == "frames"]
    return len(kept), sum(g["replays"] for g in kept)


@pytest.mark.cuda
@pytest.mark.parametrize("total,bf,done,mode,chunk", [
    (11, 3, 0, "int16", None),      # four batches over two staging sets
    (8, 3, 0, "float32", None),     # a partial last batch of two frames
    (10, 3, 4, "int16", None),      # a resumed writer: frames 4..9
    (9, 2, 0, "iq", None),          # complex64 reads, five batches
    # 1 MiB + 5 B chunks (not a divisor of a 1.5 MB frame) through the
    # two-slot ring, so slots are refilled within a batch
    (11, 3, 0, "float32", (1 << 20) + 5),
])
def test_run_capture_feed_maps_equal_the_eager_chain(cuda, monkeypatch,
                                                     total, bf, done, mode,
                                                     chunk):
    """run_capture's card feed (the halo copied on the card, the new frames
    streamed in chunks on a copy stream) writes each batch's maps bit for
    bit as the eager chain gives them on the buffer assembled in numpy;
    every frame crosses from the host once, two slots a batch after the
    first are reused on the card, and no graph is captured after the
    first batch."""
    from passiveradar_torch import feed
    from passiveradar_torch import pipeline as pl
    if chunk is not None:
        monkeypatch.setattr(feed, "CHUNK_BYTES", chunk)
    cfg, ref, srv, _ = _graph_batch(
        cuda, "int16" if mode == "int16" else "float32", nfr=total,
        num_frames=total)
    ref, srv = ref.cpu().numpy(), srv.cpu().numpy()
    ref[0] = srv[0] = ref[1]                    # no zero frame here
    reader = _MemIQReader(ref, srv) if mode == "iq" else _MemReader(ref, srv)
    writer = _MemWriter((total, cfg.num_doppler_cells,
                         cfg.num_range_cells + 1))
    writer.frames_done = done
    counted, (kept, replays) = feed.stage_info(), _frames_graphs()
    assert pl.run_capture(reader, writer, cfg, batch_frames=bf,
                          progress=False, device=cuda) == total
    batches = -(-(total - done) // bf)
    new_kept, new_replays = _frames_graphs()
    assert new_kept - kept <= 1
    assert new_replays - replays == batches - (new_kept - kept)
    stats = {k: v - counted[k] for k, v in feed.stage_info().items()}
    first = done - 1 if done else 0
    assert stats["batches"] == batches
    assert stats["frames_sent"] == 2 * (total - first)
    assert stats["frames_reused"] == 2 * 2 * (batches - 1)
    assert stats["bytes_sent"] == ref[0].nbytes * 2 * (total - first)
    for start in range(done, total, bf):
        count = min(bf, total - start)
        slots = range(start - 1, start + bf + 1)
        buf = [np.stack([x[i] if 0 <= i < total else np.zeros_like(x[0])
                         for i in slots]) for x in (ref, srv)]
        ph = np.array([pl.frame_phases(cfg, [i])[0] if 0 <= i < total else 0
                       for i in slots], np.float32)
        want = pl._process_frames_impl(
            *(torch.from_numpy(b).to(cuda) for b in buf),
            torch.from_numpy(ph).to(cuda), cfg).cpu().numpy()
        np.testing.assert_array_equal(writer.maps[start:start + count],
                                      want[1:1 + count])
    assert not writer.maps[:done].any()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ls_multiple", "nlms_pallas"])
def test_process_frames_shmap_one_card_graphed_equals_process_frames(
        cuda, method):
    """One shard on the card: the clean graph, the exchange (zero halos)
    and the halo_caf graph give process_frames' maps bit for bit; a second
    call replays both graphs."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import graphs
    from passiveradar_torch.parallel.mesh import make_mesh
    cfg, ref, srv, ph = _graph_batch(cuda, clutter_method=method)
    want = pl.process_frames(ref, srv, ph, cfg)
    mesh = make_mesh(devices=[cuda])
    runs = [torch.cat(pl.process_frames_shmap(ref, srv, ph, cfg, mesh))
            for _ in range(2)]
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got, want)
    kinds = [g["kind"] for g in graphs.cache_info()
             if g["key"].get("clutter_method") == method]
    assert {"clean", "halo_caf"} <= set(kinds)


@pytest.mark.cuda
def test_stream_graphs_match_eager(cuda):
    """The stream on the card: each push's clean step and CAF + CFAR step
    replay graphs; the results equal the eager steps on the same card."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops.caf import fast_xambg
    from passiveradar_torch.ops.cfar import cfar_2d
    cfg, ref, srv, ph = _graph_batch(cuda, nfr=4)
    ref, srv = torch.view_as_complex(ref), torch.view_as_complex(srv)
    sp = StreamingProcessor(cfg, device=cuda)
    res = [sp.push(ref[i], srv[i]) for i in range(4)][1:] + [sp.flush()]
    h = cfg.window_overlap
    clean = [pl._clean_impl(ref[i:i + 1], srv[i:i + 1], ph[i:i + 1], cfg)
             for i in range(4)]
    z = torch.zeros(h, dtype=torch.complex64, device=cuda)
    for i, r in enumerate(res):
        left = (z, z) if i == 0 else (clean[i - 1][0][0, -h:],
                                      clean[i - 1][1][0, -h:])
        right = (z, z) if i == 3 else (clean[i + 1][0][0, :h],
                                       clean[i + 1][1][0, :h])
        caf = fast_xambg(torch.cat([left[0], clean[i][0][0], right[0]]),
                         torch.cat([left[1], clean[i][1][0], right[1]]),
                         cfg.num_range_cells, cfg.num_doppler_cells,
                         window=sp._window, short_filt=cfg.caf_short_filt)
        np.testing.assert_array_equal(r.caf, caf.cpu().numpy())
        np.testing.assert_array_equal(
            r.cfar, cfar_2d(caf.abs(), *sp.cfar_kernel).cpu().numpy())


@pytest.mark.cuda
def test_file_capture_maps_equal_the_ring_path(cuda, tmp_path, monkeypatch):
    """cli.process's sequence on the card over a 25-frame int16 HDF5
    capture of the benchmark's fm_upstream_file geometry under TMPDIR (an
    8-frame ring tiled, a planted skew of 31,415 samples, the reference
    channel leading), read by io/hdf5_min: the offset search finds the
    skew exactly, every batch is read straight into the prefetch reader's
    pool (``read_info()``'s ``direct``, at most four buffer pairs), and
    run_capture writes 24 maps bit for bit as it does over a ring reader
    of the same int16 frames."""
    from benchmark.core import cells, scene
    from benchmark.reference import geometry
    from benchmark.traffic import file_capture, ring_capture
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.io import hdf5 as port_hdf5
    from passiveradar_torch.io import hdf5_min
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.io.writers import (MapWriter, hdf5_backend,
                                               write_metadata)
    monkeypatch.setattr(port_hdf5, "hdf5_backend", lambda: hdf5_min)
    cell = cells.find("fm_file")
    g = geometry.derive(cell.config)
    ref, srv = scene.make_ring(g, cell.mix["scene"], 8, 3, cuda)
    rings = [scene.to_int16_pairs(x, g["int16_scale"]) for x in (ref, srv)]
    del ref, srv
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, cell.config, *rings, 25, -31415)
    cfg = derive_config(dict(cell.config, input_file=path, num_frames=24,
                             output_fname=str(tmp_path / "XAMBG")))
    reader = CaptureReader(cfg, device=cuda)
    before = port_hdf5.read_info()
    try:
        assert isinstance(reader._file, hdf5_min.File)
        assert reader.offset == -31415 and reader.num_frames == 25
        total = pl.capture_frame_count(reader, cfg)
        writer = MapWriter(cfg, total)
        try:
            assert pl.run_capture(reader, writer, cfg, progress=False,
                                  device=cuda) == 24
        finally:
            writer.close()
    finally:
        reader.close()
    write_metadata(cfg, total)
    after = port_hdf5.read_info()
    assert after["direct"] - before["direct"] == \
        after["batches"] - before["batches"] == -(-24 // cfg.frame_batch)
    assert 1 <= after["buffers"] - before["buffers"] <= 4
    margin = cfg.frame_batch + 2
    ring = ring_capture.RingReader(
        *(np.concatenate([x, x[:margin]]) for x in rings), 8, 0, 25)
    want = _MemWriter((24, cfg.num_doppler_cells, cfg.num_range_cells + 1))
    pl.run_capture(ring, want, cfg, progress=False, device=cuda)
    with hdf5_backend().File(cfg.range_doppler_map_fname, "r") as f:
        assert int(f["/xambg"].attrs["frames_done"]) == 24
        got = np.moveaxis(np.asarray(f["/xambg"][:, :, :]), 2, 0)
    np.testing.assert_array_equal(got, want.maps)
