"""The port's channelizer and wideband chain against the JAX package, on the
CPU, at tests/test_wideband.py's geometry (WB: 4 channels of 16,384 Hz,
4,096 samples a channel, 64 Doppler × 9 range cells).

Tolerances: the channelizer within 1e-6 of the peak (the same float32
multiply-adds in the same order, then a K-point FFT); maps within 1e-4 of
their peak (tests/test_wideband.py's, streaming against offline; measured
~2e-7 against JAX) with equal argmax cells; the integrated stack within
rtol 1e-5 of the sum of the channel stacks; tracker tables equal in status
and lifetime, estimates within 1e-4 (tests/test_torch_streaming.py).
"""

import h5py
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu import wideband as jwb  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.ops.channelizer import \
    channelize as j_channelize  # noqa: E402
from passiveradar_tpu.ops.channelizer import \
    design_prototype as j_design_prototype  # noqa: E402
from passiveradar_torch import wideband as twb  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.hdf5 import CaptureReader  # noqa: E402
from passiveradar_torch.ops.channelizer import (  # noqa: E402
    channelize, channelize_pair, design_prototype)
from tests.test_wideband import WB, _cnoise, _wb_signals  # noqa: E402


def _cfgs(tmp_path, tag="T", **over):
    params = dict(WB, input_file=str(tmp_path / "wb.hdf5"),
                  output_fname=str(tmp_path / f"WB_{tag}"), **over)
    return params, j_derive(params), t_derive(params)


def _peak_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _argmax(m):
    return np.unravel_index(np.argmax(np.abs(m)), m.shape)


@pytest.mark.parametrize("k,taps,n", [(8, 12, 8192), (4, 12, 4096),
                                      (4, 6, 4099), (2, 3, 64)])
def test_channelize_matches_jax(k, taps, n):
    rng = np.random.default_rng(k * 100 + taps)
    x = _cnoise(rng, n)
    want = np.asarray(j_channelize(x, k, taps))
    got = channelize(x, k, taps, device="cpu")
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape == (n // k, k)
    assert _peak_rel(got.numpy(), want) <= 1e-6
    # a batch of frames rides along: each row as on its own
    batch = np.stack([x, x[::-1].copy()])
    got_b = channelize(torch.from_numpy(batch), k, taps).numpy()
    np.testing.assert_array_equal(got_b[0], got.numpy())
    assert _peak_rel(got_b[1], np.asarray(j_channelize(batch[1], k, taps))) \
        <= 1e-6
    np.testing.assert_array_equal(design_prototype(k, taps),
                                  j_design_prototype(k, taps))


def test_tone_lands_in_its_channel():
    k, n = 8, 8192
    fs = 8192.0
    f0 = 3 * fs / k + 5.0                 # channel 3, +5 Hz off its centre
    t = np.arange(n) / fs
    x = np.exp(1j * 2 * np.pi * f0 * t).astype(np.complex64)
    ch = channelize(x, k, device="cpu").numpy()
    power = np.mean(np.abs(ch) ** 2, axis=0)
    assert np.argmax(power) == 3
    assert power[3] > 1000 * np.sort(power)[-2]      # > 30 dB rejection
    spec = np.abs(np.fft.fft(ch[64:, 3]))
    m = ch[64:, 3].shape[0]
    assert abs(np.argmax(spec) / m * (fs / k) - 5.0) < 2 * (fs / k) / m


def test_channelizer_preserves_cross_channel_correlation():
    """Phase-matched banks: a wideband delay of 8 samples stays a delay of 2
    channel samples in every channel."""
    rng = np.random.default_rng(4)
    k, n = 4, 4096
    base = np.convolve(_cnoise(rng, n), np.ones(4) / 4, "same").astype(
        np.complex64)
    rc, sc = channelize_pair(base, np.roll(base, 8), k, device="cpu")
    rc, sc = rc.numpy(), sc.numpy()
    for ch in range(k):
        r, s = rc[32:, ch], sc[32:, ch]
        lags = [np.abs(np.vdot(r[:-4], s[d:d + len(r) - 4]))
                for d in range(4)]
        assert np.argmax(lags) == 2


def test_process_wideband_frame_matches_jax():
    """tests/test_wideband.py's two-station scene (echo 8 wideband samples
    late, +6 Hz): maps within 1e-4 of the peak, the echo at its cell in
    both stations' channels and in the integrated map."""
    rng = np.random.default_rng(12345)
    k, n = 4, 4096 * 4
    fs = float(n)
    t = np.arange(n) / fs
    s1 = np.convolve(_cnoise(rng, n), np.ones(8) / 8, "same")
    s2 = np.convolve(_cnoise(rng, n), np.ones(8) / 8, "same")
    ref = (s1 * np.exp(1j * 2 * np.pi * (fs / k) * t)
           + s2 * np.exp(1j * 2 * np.pi * (2 * fs / k) * t)).astype(
        np.complex64)
    echo = np.roll(ref, 8) * np.exp(1j * 2 * np.pi * 6.0 * t)
    srv = (0.7 * ref + 0.1 * echo + 1e-3 * _cnoise(rng, n)).astype(
        np.complex64)
    kw = dict(filter_len=6, sample_rate=fs, doppler_bins=(0,),
              window=("kaiser", 5.0))
    want = np.asarray(jwb.process_wideband_frame(ref, srv, k, 8, 64, **kw))
    got = twb.process_wideband_frame(ref, srv, k, 8, 64, device="cpu", **kw)
    assert tuple(got.shape) == want.shape == (k, 64, 9)
    got = got.numpy()
    assert _peak_rel(got, want) <= 1e-4
    for ch in (1, 2):
        assert _argmax(got[ch]) == _argmax(want[ch])
        fbin, rbin = _argmax(got[ch])
        assert rbin == 8 - 8 // k and abs(fbin - (32 - 6)) <= 1
    integ = twb.integrate_channels(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(
        integ, np.asarray(jwb.integrate_channels(want)), rtol=1e-4,
        atol=1e-5 * np.max(integ))
    assert _argmax(integ)[1] == 8 - 8 // k


@pytest.mark.parametrize("pairs", [False, True])
def test_wideband_frames_matches_jax(tmp_path, pairs):
    """Three CPIs, channels (1, 2), as complex64 and as float32 IQ pairs:
    maps within 1e-4 of the peak with equal argmax cells."""
    _, cfg_j, cfg_t = _cfgs(tmp_path)
    ref, srv = _wb_signals(cfg_j, 3, np.random.default_rng(12345))
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    r3, s3 = ref.reshape(3, n), srv.reshape(3, n)
    want = np.asarray(jwb.wideband_frames(r3, s3, cfg_j))
    if pairs:
        r3 = r3.view(np.float32).reshape(3, n, 2)
        s3 = s3.view(np.float32).reshape(3, n, 2)
    got = twb.wideband_frames(r3, s3, cfg_t, device="cpu")
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape == (3, 2, 64, 9)
    got = got.numpy()
    assert _peak_rel(got, want) <= 1e-4
    for f in range(3):
        for i in range(2):
            assert _argmax(got[f, i]) == _argmax(want[f, i])


def _write_capture(path, ref, srv):
    with h5py.File(path, "w") as f:
        f.create_dataset("/data/ref", data=ref.view(np.float32))
        f.create_dataset("/data/srv", data=srv.view(np.float32))


def test_run_wideband_capture_matches_jax_cli(tmp_path):
    """run_wideband_capture(integrate=True) over a 3-CPI capture in batches
    of 2 (a zero-padded last batch): each channel stack against the JAX
    CLI's, and the integrated stack against the sum of the channel
    stacks."""
    params_j, cfg_j, _ = _cfgs(tmp_path, "J")
    _, _, cfg_t = _cfgs(tmp_path, "T")
    _write_capture(params_j["input_file"],
                   *_wb_signals(cfg_j, 3, np.random.default_rng(12345)))
    cfg_path = tmp_path / "wb.yaml"
    cfg_path.write_text(yaml.safe_dump(params_j))
    from passiveradar_tpu.cli.wideband import main as j_main
    j_main(["--config", str(cfg_path), "--integrate"])

    reader = CaptureReader(cfg_t, device="cpu")
    n = twb.run_wideband_capture(reader, cfg_t, progress=False,
                                 integrate=True, device="cpu")
    reader.close()
    assert n == 3
    stacks = {}
    for ch in (1, 2):
        with h5py.File(twb.channel_path(cfg_t, ch)) as f:
            stacks[ch] = np.asarray(f["/xambg"])
        with h5py.File(jwb.channel_path(cfg_j, ch)) as f:
            want = np.asarray(f["/xambg"])
        assert stacks[ch].shape == want.shape == (64, 9, 3)
        assert _peak_rel(stacks[ch], want) <= 1e-4
        for fr in range(3):
            assert _argmax(stacks[ch][:, :, fr]) == _argmax(want[:, :, fr])
    with h5py.File(twb.integrated_path(cfg_t)) as f:
        integ = np.asarray(f["/xambg"])
    with h5py.File(jwb.integrated_path(cfg_j)) as f:
        j_integ = np.asarray(f["/xambg"])
    total = np.abs(stacks[1]) + np.abs(stacks[2])
    np.testing.assert_allclose(np.real(integ), total, rtol=1e-5,
                               atol=1e-5 * np.max(total))
    assert np.max(np.abs(np.imag(integ))) == 0.0
    assert _peak_rel(integ, j_integ) <= 1e-4


def _tables_agree(got, want):
    np.testing.assert_array_equal(got["status"], np.asarray(want["status"]))
    np.testing.assert_array_equal(got["lifetime"],
                                  np.asarray(want["lifetime"]))
    np.testing.assert_allclose(got["estimate"], np.asarray(want["estimate"]),
                               atol=1e-4, rtol=1e-6)


# WB's 9 range cells lie wholly in get_measurements' 8-row edge zones, so
# every candidate there is a zero and the pool's order is a tie-break; the
# tracker comparison takes 33 range cells and puts the echo outside the
# zeroed zones (12 channel samples late, +40 Hz: 10 Doppler cells)
TRACK_GEOMETRY = dict(max_range_nominal=600.0)
TRACK_ECHO = dict(delay=48, dop=40.0)
STREAM_CPIS = 5


def test_wideband_streaming_matches_offline_and_jax(tmp_path):
    """Full-detail pushes: each channel's CAF against the port's offline
    wideband_frames and the JAX processor's, the CFAR map, and the
    per-channel track tables against the JAX processor's."""
    _, cfg_j, cfg_t = _cfgs(tmp_path, **TRACK_GEOMETRY)
    nfr = STREAM_CPIS
    ref, srv = _wb_signals(cfg_j, nfr, np.random.default_rng(12345),
                           **TRACK_ECHO)
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    offline = twb.wideband_frames(ref.reshape(nfr, n), srv.reshape(nfr, n),
                                  cfg_t, device="cpu").numpy()
    sp = twb.WidebandStreamingProcessor(cfg_t, n_tracks=4, device="cpu")
    jsp = jwb.WidebandStreamingProcessor(cfg_j, n_tracks=4)
    for fr in range(nfr):
        chunk = (ref[fr * n:(fr + 1) * n], srv[fr * n:(fr + 1) * n])
        got = sp.push(*chunk)
        want = jsp.push(*chunk)
        assert set(got) == set(want) == {1, 2}
        for i, ch in enumerate((1, 2)):
            res = got[ch]
            assert res.frame_index == fr
            assert res.caf.dtype == np.complex64
            assert _peak_rel(res.caf, offline[fr, i]) <= 1e-4
            assert _peak_rel(res.caf, want[ch].caf) <= 1e-4
            np.testing.assert_allclose(res.cfar, want[ch].cfar, rtol=1e-4,
                                       atol=1e-5 * np.max(res.cfar))
            assert res.tracks["status"].shape == (4,)
            _tables_agree(res.tracks, want[ch].tracks)
    # the echo's track is live in every channel
    for ch, res in got.items():
        live = res.tracks["status"] > 0
        assert live.any(), ch


def test_wideband_streaming_summary_mode(tmp_path):
    """detail="summary" skips the map and table copies and returns the
    packed summary, equal to the full table; fetch_maps() returns the maps
    a full push would have; the per-push override works both ways."""
    _, _, cfg_t = _cfgs(tmp_path)
    ref, srv = _wb_signals(cfg_t, 2, np.random.default_rng(7))
    n = cfg_t.cpi_samples * cfg_t.wideband_channels
    full = twb.WidebandStreamingProcessor(cfg_t, n_tracks=4, device="cpu")
    light = twb.WidebandStreamingProcessor(cfg_t, n_tracks=4,
                                           detail="summary", device="cpu")
    assert light.fetch_maps() is None
    for fr in range(2):
        chunk = (ref[fr * n:(fr + 1) * n], srv[fr * n:(fr + 1) * n])
        want = full.push(*chunk)
        got = light.push(*chunk)
        maps = light.fetch_maps()
        assert set(got) == set(want) == set(maps)
        for ch in want:
            assert got[ch].caf is None and got[ch].tracks is None
            np.testing.assert_array_equal(got[ch].summary["status"],
                                          want[ch].tracks["status"])
            np.testing.assert_allclose(got[ch].summary["estimate"],
                                       want[ch].tracks["estimate"],
                                       rtol=1e-6)
            caf, cf = maps[ch]
            np.testing.assert_array_equal(caf, want[ch].caf)
            np.testing.assert_array_equal(cf, want[ch].cfar)
    chunk = (ref[:n], srv[:n])
    assert light.push(*chunk, detail="full")[1].caf is not None
    assert full.push(*chunk, detail="summary")[1].caf is None
    with pytest.raises(ValueError):
        full.push(*chunk, detail="maps")


def test_wideband_streaming_needs_a_wideband_config(tmp_path):
    _, _, cfg_t = _cfgs(tmp_path)
    narrow = t_derive(dict(WB, wideband_channels=0))
    with pytest.raises(ValueError, match="wideband_channels"):
        twb.WidebandStreamingProcessor(narrow, device="cpu")
    with pytest.raises(ValueError, match="detail"):
        twb.WidebandStreamingProcessor(cfg_t, detail="maps", device="cpu")


class _IQFrames:
    """A wideband capture in memory, read as complex64 CPIs (the
    CaptureReader's read_iq_frames)."""

    def __init__(self, ref, srv):
        self.ref, self.srv = ref, srv
        self.num_frames = ref.shape[0]

    def read_iq_frames(self, start, count):
        return self.ref[start:start + count], self.srv[start:start + count]


class _MemStack:
    """A MapWriter in memory: (frames, nf, R+1) complex64."""

    def __init__(self, cfg, total, path=None):
        self.maps = np.zeros((total, cfg.num_doppler_cells,
                              cfg.num_range_cells + 1), np.complex64)

    def write(self, frames, start):
        self.maps[start:start + len(frames)] = frames

    def close(self):
        pass


@pytest.mark.parametrize("chunk", [None, 3 * 4096 + 5])
def test_run_wideband_capture_feed_is_bit_equal_to_numpy_batches(
        tmp_path, monkeypatch, chunk):
    """run_wideband_capture(integrate=True) over 11 CPIs in batches of 4
    (a short last batch), every batch through feed.CardFeed on the CPU:
    each channel's maps and the integrated stack bit for bit as
    wideband_frames gives them on zero-padded numpy batches; each CPI is
    sent once, in chunks smaller than a CPI where CHUNK_BYTES says so, and
    the slots outside a batch's CPIs are zeroed."""
    from passiveradar_torch import feed
    from passiveradar_torch.io import writers as tw
    if chunk is not None:
        monkeypatch.setattr(feed, "CHUNK_BYTES", chunk)
    made = []

    def mem_stack(*args, **kwargs):
        made.append(_MemStack(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tw, "MapWriter", mem_stack)
    total, bf = 11, 4
    _, cfg_j, cfg = _cfgs(tmp_path, num_frames=total)
    n = cfg.cpi_samples * cfg.wideband_channels
    ref, srv = (x.reshape(total, n) for x in _wb_signals(
        cfg_j, total, np.random.default_rng(7)))
    stacks = {k: _MemStack(cfg, total) for k in cfg.wideband_channel_select}
    counted = feed.stage_info()
    assert twb.run_wideband_capture(
        _IQFrames(ref, srv), cfg, batch_frames=bf, writers=stacks,
        progress=False, integrate=True, device="cpu") == total
    stats = {k: v - counted[k] for k, v in feed.stage_info().items()}
    counts = [min(bf, total - s) for s in range(0, total, bf)]
    assert stats == dict(
        calls=1, batches=3, frames_sent=2 * total, frames_reused=0,
        frames_zeroed=2 * sum(bf + 2 - c for c in counts),
        bytes_sent=2 * total * ref[0].nbytes,
        chunks=2 * sum(-(-c * ref[0].nbytes // feed.CHUNK_BYTES)
                       for c in counts),
        slot_waits=0)
    (integ,) = made
    for s, c in zip(range(0, total, bf), counts):
        bufs = [np.zeros((bf, n), np.complex64) for _ in range(2)]
        for buf, x in zip(bufs, (ref, srv)):
            buf[:c] = x[s:s + c]
        want = twb.wideband_frames(*bufs, cfg, device="cpu")[:c]
        for i, k in enumerate(cfg.wideband_channel_select):
            np.testing.assert_array_equal(stacks[k].maps[s:s + c],
                                          want[:, i].numpy())
        np.testing.assert_array_equal(
            integ.maps[s:s + c],
            want.abs().sum(dim=1).numpy().astype(np.complex64))
