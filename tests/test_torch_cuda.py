"""Card-only checks of the port: the CUDA kernels against their plain
versions, and the whole chain and the streaming processor on the card
against the CPU.

Marked ``cuda``; each test skips when no CUDA card is present (decided in
the fixture, at run time). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import ctypes

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
from passiveradar_torch.ops.clutter import ls_filter_multiple  # noqa: E402
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
