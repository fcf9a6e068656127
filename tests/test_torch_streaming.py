"""The port's StreamingProcessor and cli.stream against the JAX package, on
the CPU.

TINY geometry (tests/test_pipeline.py:23). Tolerances are those of
tests/test_streaming.py: each streamed CAF within 1e-3 of its peak (here
against the JAX processor's CAF and against the port's own batch run), and
track tables equal in status and lifetime, with estimates within 1e-4.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.io.synthetic import \
    write_synth_capture as j_write  # noqa: E402
from passiveradar_tpu.streaming import \
    StreamingProcessor as JSP  # noqa: E402
from passiveradar_torch import streaming as ts  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, write_synth_capture)
from passiveradar_torch.pipeline import frame_phases, process_frames  # noqa: E402
from tests.test_pipeline import TINY, _make_frames  # noqa: E402

N_FRAMES = 11
N_TRACKS = 4


def _run(sp, ref, srv, detail=None, wrap=None):
    """Push every frame, then flush; the results in order."""
    out = []
    for f in range(len(ref)):
        a, b = (ref[f], srv[f]) if wrap is None else (wrap(ref[f]),
                                                      wrap(srv[f]))
        res = sp.push(a, b, detail=detail)
        if res is not None:
            out.append(res)
    out.append(sp.flush(detail=detail))
    return out


@pytest.fixture(scope="module")
def scene():
    """TINY frames with one target, and the JAX processor's full results
    over them, computed once."""
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    ref, srv = _make_frames(cfg_j, N_FRAMES, (JTarget(40, 20.0, 0.3),),
                            seed=7)
    want = _run(JSP(cfg_j, n_tracks=N_TRACKS), ref, srv)
    return cfg_t, ref, srv, want


def _assert_result_agrees(got, want):
    assert got.frame_index == want.frame_index
    peak = np.max(np.abs(want.caf))
    assert got.caf.dtype == np.complex64
    assert np.max(np.abs(np.abs(got.caf) - np.abs(want.caf))) < 1e-3 * peak
    assert got.cfar.shape == want.cfar.shape
    _assert_tracks_agree(got.tracks, want.tracks)


def _assert_tracks_agree(got, want):
    np.testing.assert_array_equal(got["status"], np.asarray(want["status"]))
    np.testing.assert_array_equal(got["lifetime"],
                                  np.asarray(want["lifetime"]))
    for k in ("estimate", "measurement"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4,
                                   rtol=1e-6)


def test_streaming_full_matches_jax(scene):
    cfg, ref, srv, want = scene
    got = _run(ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu"),
               ref, srv)
    assert [r.frame_index for r in got] == list(range(N_FRAMES))
    for g, w in zip(got, want):
        _assert_result_agrees(g, w)
    # the target is tracked: confirmed tracks by the end, as in JAX
    assert (got[-1].tracks["status"] == 2).any()


def test_streaming_matches_process_frames(scene):
    """Each streamed CAF equals the port's offline batch over the same
    frames (zero halo at both ends of the batch)."""
    cfg, ref, srv, _ = scene
    batch = np.abs(process_frames(
        ref, srv, frame_phases(cfg, list(range(N_FRAMES))), cfg,
        device="cpu").numpy())
    got = _run(ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu"),
               ref, srv)
    for r in got:
        want = batch[r.frame_index]
        assert np.max(np.abs(np.abs(r.caf) - want)) < 1e-3 * np.max(want)


def test_streaming_summary_matches_full(scene):
    """detail="summary" returns no maps and no table, a packed summary that
    equals the JAX full table, maps on demand through fetch_maps(), and the
    per-push override works both ways."""
    cfg, ref, srv, want = scene
    sp = ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, detail="summary",
                               device="cpu")
    assert sp.fetch_maps() is None
    k = 0
    for f in range(N_FRAMES):
        got = sp.push(ref[f], srv[f])
        if got is None:
            continue
        w = want[k]
        k += 1
        assert got.caf is None and got.cfar is None and got.tracks is None
        assert got.frame_index == w.frame_index
        _assert_tracks_agree(got.summary, w.tracks)
        caf, cf = sp.fetch_maps()
        peak = np.max(np.abs(w.caf))
        assert np.max(np.abs(np.abs(caf) - np.abs(w.caf))) < 1e-3 * peak
        assert cf.shape == w.cfar.shape
    got = sp.flush(detail="full")
    assert got.caf is not None and got.summary is None
    _assert_result_agrees(got, want[-1])
    full = ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu")
    full.push(ref[0], srv[0])
    res = full.push(ref[1], srv[1], detail="summary")
    assert res.caf is None and res.summary is not None


def test_streaming_device_resident_push(scene):
    """Tensors already on the processor's device (here the CPU), float32
    interleaved or complex64, give the numpy path's results."""
    cfg, ref, srv, want = scene
    n = 3
    flt = _run(ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu"),
               ref[:n], srv[:n], wrap=torch.from_numpy)
    cpx = _run(ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu"),
               ref[:n], srv[:n],
               wrap=lambda a: torch.from_numpy(a.view(np.complex64)))
    host = _run(ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu"),
                ref[:n], srv[:n])
    for a, b, h in zip(flt, cpx, host):
        np.testing.assert_array_equal(a.caf, h.caf)
        np.testing.assert_array_equal(b.caf, h.caf)


def test_streaming_no_overlap_matches_jax():
    params = dict(TINY, overlap_cpi=False)
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    assert cfg_t.window_overlap == 0
    ref, srv = _make_frames(cfg_j, 3, (JTarget(40, 20.0, 0.12),))
    want = _run(JSP(cfg_j, n_tracks=N_TRACKS), ref, srv)
    got = _run(ts.StreamingProcessor(cfg_t, n_tracks=N_TRACKS,
                                     device="cpu"), ref, srv)
    assert [r.frame_index for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        _assert_result_agrees(g, w)


def test_streaming_uses_scaled_candidate_budget(monkeypatch):
    cfg = dataclasses.replace(t_derive(TINY), max_measurements=7)
    assert cfg.candidate_budget != cfg.max_measurements
    seen = []
    real = ts.multitarget_step

    def spy(tracks, cf, extent, n_tracks, k_max):
        seen.append(k_max)
        return real(tracks, cf, extent, n_tracks, k_max)

    monkeypatch.setattr(ts, "multitarget_step", spy)
    ref, srv = _make_frames(cfg, 2, (Target(40, 20.0, 0.12),))
    sp = ts.StreamingProcessor(cfg, n_tracks=N_TRACKS, device="cpu")
    sp.push(ref[0], srv[0])
    sp.push(ref[1], srv[1])
    assert seen == [cfg.candidate_budget]


def test_streaming_rejects_what_is_not_ported():
    cfg = t_derive(TINY)
    with pytest.raises(ValueError, match="detail"):
        ts.StreamingProcessor(cfg, detail="light", device="cpu")
    # the flattop CAF is ported: a caf_short_filt: false config is taken
    assert not ts.StreamingProcessor(
        dataclasses.replace(cfg, caf_short_filt=False),
        device="cpu").cfg.caf_short_filt
    sp = ts.StreamingProcessor(cfg, device="cpu")
    with pytest.raises(ValueError, match="detail"):
        sp.push(np.zeros(cfg.input_chunk_length, np.float32),
                np.zeros(cfg.input_chunk_length, np.float32), detail="x")
    assert sp.flush() is None


def test_streaming_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.StreamingProcessor(t_derive(TINY))


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """One 5-frame capture as a zarr store (for the port) and as HDF5 (for
    the JAX CLI), from the same seed."""
    ws = tmp_path_factory.mktemp("torch_stream")
    paths = {}
    for tag, ext in (("T", "zarr"), ("J", "hdf5")):
        params = dict(TINY, num_frames=5, input_file=str(ws / f"cap.{ext}"),
                      output_fname=str(ws / f"XAMBG_{tag}"))
        cap = (write_synth_capture(params["input_file"], t_derive(params), 5,
                                   targets=(Target(40, 20.0, 0.3),), seed=7)
               if tag == "T" else
               j_write(params["input_file"], j_derive(params), 5,
                       targets=(JTarget(40, 20.0, 0.3),), seed=7))
        del cap
        paths[tag] = ws / f"stream_{tag}.yaml"
        paths[tag].write_text(yaml.safe_dump(params))
    return paths


def _confirmed_by_frame(out):
    return {int(m.group(1)): sorted(re.findall(r"track(\d+):", m.group(2)))
            for m in re.finditer(r"^frame +(\d+): (.*)$", out, re.M)}


@pytest.mark.parametrize("detail", ["full", "summary"])
def test_stream_cli_matches_jax(captures, capsys, detail):
    """Both streaming CLIs on the same capture: the same frames reported
    with the same confirmed tracks; the port's returns its push latencies
    and the last track table."""
    from passiveradar_torch.cli.stream import main as t_main
    from passiveradar_tpu.cli.stream import main as j_main
    j_main(["--config", str(captures["J"]), "--max-frames", "4",
            "--tracks", str(N_TRACKS), "--detail", detail])
    want = capsys.readouterr().out
    res = t_main(["--config", str(captures["T"]), "--max-frames", "4",
                  "--tracks", str(N_TRACKS), "--detail", detail,
                  "--device", "cpu"])
    got = capsys.readouterr().out
    assert "Streamed 4 frames" in got and "frame    0" in got
    assert "push latency median" in got
    assert _confirmed_by_frame(got) == _confirmed_by_frame(want)
    assert len(_confirmed_by_frame(got)) == 4
    assert res["frames"] == 4 and len(res["push_ms"]) == 4
    assert res["tracks"]["status"].shape == (N_TRACKS,)


def test_stream_cli_refuses_wideband_and_bad_device(captures, capsys):
    """A wideband configuration streams through the wideband processor
    (refused until the wideband path was ported): one result a selected
    channel per CPI. A device other than cuda or cpu is refused."""
    from passiveradar_torch.cli.stream import main as t_main
    params = yaml.safe_load(captures["T"].read_text())
    wide = captures["T"].with_name("wide.yaml")
    wide.write_text(yaml.safe_dump(dict(params, wideband_channels=4)))
    capsys.readouterr()
    res = t_main(["--config", str(wide), "--device", "cpu",
                  "--max-frames", "1", "--tracks", "3"])
    out = capsys.readouterr().out
    assert res["frames"] == 1 and len(res["push_ms"]) == 1
    assert sorted(res["tracks"]) == [0, 1, 2, 3]
    assert res["tracks"][3]["status"].shape == (3,)
    assert "Wideband streaming" in out and "frame    0 ch3:" in out
    with pytest.raises(SystemExit):
        t_main(["--config", str(captures["T"]), "--device", "tpu"])
