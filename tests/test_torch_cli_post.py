"""The port's post-processing and wideband CLIs on the CPU (``--device
cpu``), run in a temporary working directory, against the JAX package.

cli.plot, cli.track_multi and cli.track_simple read maps that the port's
cli.process wrote from the TINY capture of tests/test_cli.py; the track
histories are held against the JAX CLIs' own chain (load_maps, cfar_stack,
the tracker) on the same file: discrete state equal, estimates within atol
1e-4 (tests/test_torch_detect.py). cli.wideband and the wideband branch of
cli.stream run on a 10-CPI capture at tests/test_wideband.py's rates (33
range cells, so the tracker sees the echo): the channel stacks within 1e-4
of their peak of the JAX CLI's, and each streamed CPI reports the same
confirmed tracks per channel as the JAX stream CLI.
"""

import os
import re

import h5py
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu.cli import plot as jplot  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.detect import trackers as jt  # noqa: E402
from passiveradar_tpu.io import writers as jw  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.io.synthetic import \
    write_synth_capture as j_write  # noqa: E402
from passiveradar_tpu.wideband import channel_path as j_channel_path  # noqa: E402
from passiveradar_torch.cli import plot as tplot  # noqa: E402
from passiveradar_torch.cli import process as tprocess  # noqa: E402
from passiveradar_torch.cli import stream as tstream  # noqa: E402
from passiveradar_torch.cli import track_multi as tmulti  # noqa: E402
from passiveradar_torch.cli import track_simple as tsimple  # noqa: E402
from passiveradar_torch.cli import wideband as twide  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.wideband import channel_path, \
    integrated_path  # noqa: E402
from tests.test_cli import TINY  # noqa: E402
from tests.test_wideband import WB, _wb_signals  # noqa: E402

WB_CPIS = 10   # a track confirms at its tenth CPI (frame 9)
WB_ECHO = dict(delay=48, dop=40.0)   # 12 channel samples, 10 Doppler cells


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The TINY capture (one target) and the port's cli.process maps."""
    ws = tmp_path_factory.mktemp("torch_cli_post")
    params = dict(TINY, input_file=str(ws / "cap.hdf5"),
                  output_fname=str(ws / "XAMBG"))
    j_write(params["input_file"], j_derive(params), 6,
            targets=(JTarget(40, 20.0, 0.12),))
    cfg_path = ws / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(params))
    tprocess.main(["--config", str(cfg_path), "--device", "cpu"])
    return ws, str(cfg_path), j_derive(params), t_derive(params)


def test_plot_cli_frames(maps, tmp_path, monkeypatch):
    ws, cfg_path, _, cfg = maps
    monkeypatch.chdir(tmp_path)
    out = tplot.main(["--config", cfg_path, "--mode", "frames",
                      "--device", "cpu"])
    assert out == "IMG"
    pngs = sorted(f for f in os.listdir(tmp_path / "IMG")
                  if f.endswith(".png"))
    assert pngs == [f"img_{k:04d}.png" for k in range(6)]


def _assert_tables(got, want, keys_exact, keys_close):
    for k in keys_exact:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in keys_close:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4,
                                   rtol=1e-6, err_msg=k)


def test_track_multi_cli_plot(maps, tmp_path, monkeypatch):
    ws, cfg_path, cfg_j, cfg = maps
    monkeypatch.chdir(tmp_path)
    hist = tmulti.main(["--config", cfg_path, "--mode", "plot",
                        "--device", "cpu"])
    assert os.path.exists(tmp_path / "MULTITARGET_PLOT.png")
    cf = jplot.cfar_stack(jw.load_maps(cfg_j))
    want = jt.multitarget_tracker(
        cf, (cfg_j.max_doppler_actual, cfg_j.max_range_actual),
        tmulti.N_TRACKS, k_max=cfg_j.candidate_budget, frames_last=True)
    assert hist["status"].shape == (6, tmulti.N_TRACKS)
    _assert_tables(hist, want, ("status", "lifetime", "history"),
                   ("estimate", "measurement"))


def test_track_simple_cli_plot(maps, tmp_path, monkeypatch):
    ws, cfg_path, cfg_j, cfg = maps
    monkeypatch.chdir(tmp_path)
    hist = tsimple.main(["--config", cfg_path, "--mode", "plot",
                         "--device", "cpu"])
    assert os.path.exists(tmp_path / "TRACKER_PLOT.png")
    cf = jplot.cfar_stack(jw.load_maps(cfg_j))
    want = jt.simple_target_tracker(cf, cfg_j.max_range_actual,
                                    cfg_j.max_doppler_actual,
                                    frames_last=True,
                                    strict=cfg_j.strict_frame_parity)
    assert hist["lock_mode"].shape == (6, 4)
    _assert_tables(hist, want, ("lock_mode", "meas_idx"),
                   ("estimate", "measurement"))


def test_track_cli_video_mode_writes_frames_without_ffmpeg(
        maps, tmp_path, monkeypatch):
    """--mode video without ffmpeg writes the PNG frames in its place."""
    import passiveradar_torch.viz.render as tr
    ws, cfg_path, _, _ = maps
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tr, "has_ffmpeg", lambda: False)
    tmulti.main(["--config", cfg_path, "--mode", "video", "--device", "cpu"])
    pngs = os.listdir(tmp_path / "MULTITARGET_VIDEO_frames")
    assert len([f for f in pngs if f.endswith(".png")]) == 6


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """A 10-CPI wideband capture (HDF5) with one echo, and configs writing
    to a JAX and a port output prefix."""
    ws = tmp_path_factory.mktemp("torch_cli_wide")
    base = dict(WB, input_file=str(ws / "wb.hdf5"), num_frames=WB_CPIS,
                max_range_nominal=600.0)
    ref, srv = _wb_signals(j_derive(base), WB_CPIS,
                           np.random.default_rng(12345), **WB_ECHO)
    with h5py.File(base["input_file"], "w") as f:
        f.create_dataset("/data/ref", data=ref.view(np.float32))
        f.create_dataset("/data/srv", data=srv.view(np.float32))
    paths = {}
    for tag in ("J", "T"):
        params = dict(base, output_fname=str(ws / f"WB_{tag}"))
        paths[tag] = ws / f"wb_{tag}.yaml"
        paths[tag].write_text(yaml.safe_dump(params))
    return ws, paths


def test_wideband_cli_integrate(wide, tmp_path, monkeypatch):
    """cli.wideband --integrate: channel stacks against the JAX CLI's, the
    echo at its cell in every CPI of every channel and of the integrated
    stack, which renders through cli.plot --input; --shard (a one-device
    channel mesh here) writes the same channel stacks."""
    from passiveradar_tpu.cli.wideband import main as j_main
    ws, paths = wide
    cfg_j = j_derive(yaml.safe_load(paths["J"].read_text()))
    cfg = t_derive(yaml.safe_load(paths["T"].read_text()))
    j_main(["--config", str(paths["J"]), "--integrate"])
    n = twide.main(["--config", str(paths["T"]), "--integrate",
                    "--device", "cpu"])
    assert n == WB_CPIS
    nf, r = cfg.num_doppler_cells, cfg.num_range_cells
    cell = (nf // 2 - round(WB_ECHO["dop"] / cfg.doppler_cell_width),
            r - WB_ECHO["delay"] // cfg.wideband_channels)
    stacks = {}
    for ch in cfg.wideband_channel_select:
        with h5py.File(channel_path(cfg, ch)) as f:
            got = stacks[ch] = np.asarray(f["/xambg"])
        with h5py.File(j_channel_path(cfg_j, ch)) as f:
            want = np.asarray(f["/xambg"])
        assert got.shape == want.shape == (nf, r + 1, WB_CPIS)
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
        for fr in range(WB_CPIS):
            m = np.abs(got[:, :, fr])
            assert np.unravel_index(np.argmax(m), m.shape) == cell, (ch, fr)
    with h5py.File(integrated_path(cfg)) as f:
        integ = np.abs(np.asarray(f["/xambg"]))
    for fr in range(WB_CPIS):
        m = integ[:, :, fr]
        assert np.unravel_index(np.argmax(m), m.shape) == cell
    assert np.load(cfg.meta_fname)["frame_timestamps"].shape == (WB_CPIS,)

    monkeypatch.chdir(tmp_path)
    tplot.main(["--config", str(paths["T"]), "--mode", "frames",
                "--input", integrated_path(cfg), "--device", "cpu"])
    assert len(os.listdir(tmp_path / "IMG")) == WB_CPIS
    assert twide.main(["--config", str(paths["T"]), "--shard",
                       "--device", "cpu"]) == WB_CPIS
    for ch, want in stacks.items():
        with h5py.File(channel_path(cfg, ch)) as f:
            got = np.asarray(f["/xambg"])
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def _confirmed(out):
    return {(int(m.group(1)), int(m.group(2))):
            sorted(re.findall(r"track(\d+):", m.group(3)))
            for m in re.finditer(r"^frame +(\d+) ch(\d+): (.*?)(?: \(|$)",
                                 out, re.M)}


@pytest.mark.parametrize("detail", ["full", "summary"])
def test_stream_cli_wideband_matches_jax(wide, capsys, detail):
    """cli.stream on a wideband config: every CPI reported per selected
    channel with the same confirmed tracks as the JAX stream CLI, a
    confirmed track in every channel by the last CPI, and the per-channel
    tables returned."""
    from passiveradar_tpu.cli.stream import main as j_main
    ws, paths = wide
    j_main(["--config", str(paths["J"]), "--detail", detail])
    want = _confirmed(capsys.readouterr().out)
    res = tstream.main(["--config", str(paths["T"]), "--detail", detail,
                        "--device", "cpu"])
    got = _confirmed(capsys.readouterr().out)
    assert len(got) == WB_CPIS * len(WB["wideband_channel_select"])
    assert got == want
    assert res["frames"] == WB_CPIS and len(res["push_ms"]) == WB_CPIS
    assert sorted(res["tracks"]) == list(WB["wideband_channel_select"])
    for ch, table in res["tracks"].items():
        assert (np.asarray(table["status"]) == 2).any(), ch
