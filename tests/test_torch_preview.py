"""The port's cli.preview against the JAX package's, on the CPU, at TINY.

welch_psd is held to the JAX welch_psd within 1e-5 of the peak in linear
power; the numeric core (preview_arrays) to the arrays the JAX CLI plots,
recorded from matplotlib's Axes.plot around the JAX main: the PSDs within
1e-4 of the peak in linear power, |xcorr| within 1e-4 of its peak with the
argmax equal, and the channel offset equal.
"""

import os

import matplotlib
import matplotlib.axes
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu.cli.preview import main as j_main  # noqa: E402
from passiveradar_tpu.cli.preview import welch_psd as j_welch  # noqa: E402
from passiveradar_torch.cli.preview import (  # noqa: E402
    NLAG, main, preview_arrays, welch_psd)
from passiveradar_torch.config import derive_config  # noqa: E402
from passiveradar_torch.io.hdf5 import CaptureReader  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, write_synth_capture)
from tests.test_torch_pipeline import TINY  # noqa: E402

matplotlib.use("Agg")


def _close_linear(got_db, want_db, tol):
    got, want = 10 ** (got_db / 10), 10 ** (want_db / 10)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < tol * np.max(want)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_preview")
    params = dict(TINY, num_frames=3, input_file=str(ws / "cap.hdf5"))
    cfg = derive_config(params)
    write_synth_capture(params["input_file"], cfg, 3,
                        targets=(Target(40, 20.0, 0.1),), channel_offset=5)
    cfg_path = ws / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(params))
    return ws, str(cfg_path), cfg


@pytest.mark.parametrize("nperseg", [4096, 1024])
def test_welch_psd_matches_jax(nperseg, cnoise, rng):
    x = cnoise(rng, 3 * nperseg + 77) * np.exp(
        0.02j * np.arange(3 * nperseg + 77)).astype(np.complex64)
    got = welch_psd(x, nperseg, device="cpu")
    assert got.shape == (nperseg,) and got.dtype == np.float32
    _close_linear(got, j_welch(x, nperseg), 1e-5)
    # a tensor is computed on where it lies
    _close_linear(welch_psd(torch.from_numpy(x), nperseg), got, 1e-7)


def test_welch_psd_window_is_symmetric(cnoise, rng):
    """The JAX package's window is the symmetric Hann (jnp.hanning); a
    periodic one, torch.hann_window's default, misses the bound."""
    nperseg = 64
    x = cnoise(rng, 8 * nperseg)
    segs = torch.from_numpy(x).reshape(-1, nperseg)
    win = torch.hann_window(nperseg, dtype=torch.float32)      # periodic
    spec = torch.fft.fftshift(torch.fft.fft(segs * win, dim=1), dim=1)
    periodic = (10 * torch.log10(torch.mean(spec.abs() ** 2, 0) + 1e-12)
                ).numpy()
    want = j_welch(x, nperseg)
    with pytest.raises(AssertionError):
        _close_linear(periodic, want, 1e-5)
    _close_linear(welch_psd(x, nperseg, device="cpu"), want, 1e-5)


def test_preview_arrays_match_the_jax_plot(workspace, monkeypatch, capsys):
    ws, cfg_path, cfg = workspace
    monkeypatch.chdir(ws)
    plotted = []
    orig = matplotlib.axes.Axes.plot

    def record(self, *args, **kw):
        plotted.append(np.asarray(args[1]))
        return orig(self, *args, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", record)
    j_main(["--config", cfg_path])
    out = capsys.readouterr().out
    assert len(plotted) == 5
    j_offset = int(out.split("Estimated channel offset: ")[1].split()[0])
    reader = CaptureReader(cfg, max_offset_lags=50_000, device="cpu")
    got = preview_arrays(cfg, reader, "cpu")
    reader.close()
    assert got["offset"] == j_offset == -5
    for key, want in zip(("raw_psd_ref", "raw_psd_srv", "ch_psd_ref",
                          "ch_psd_srv"), plotted):
        _close_linear(got[key], want, 1e-4)
    xc, want = got["xcorr"], plotted[4]
    assert xc.shape == want.shape == (2 * NLAG + 1,)
    assert np.max(np.abs(xc - want)) < 1e-4 * np.max(want)
    assert np.argmax(xc) == np.argmax(want)


def test_main_writes_the_png(workspace, monkeypatch, capsys):
    ws, cfg_path, _ = workspace
    monkeypatch.chdir(ws)
    if os.path.exists("SIGNAL_PREVIEW.png"):
        os.remove("SIGNAL_PREVIEW.png")
    main(["--config", cfg_path, "--device", "cpu"])
    assert os.path.exists(ws / "SIGNAL_PREVIEW.png")
    out = capsys.readouterr().out
    assert "Estimated channel offset: -5 samples" in out


def test_missing_capture_exits_with_one_line(tmp_path):
    params = dict(TINY, input_file=str(tmp_path / "missing.hdf5"))
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(yaml.safe_dump(params))
    with pytest.raises(SystemExit) as exc:
        main(["--config", str(cfg_path), "--device", "cpu"])
    msg = str(exc.value)
    assert msg.startswith("error:") and "\n" not in msg
