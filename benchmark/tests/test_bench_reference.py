"""The plain reference against passiveradar_torch on the CPU, at the small
geometry of tests/test_torch_pipeline.py (FM) and a 4-channel band
(wideband), for what each traffic kind compares: the FM batch chain
(ring_capture), the stream's CAF, CFAR and tracker step (closed_push), the
wideband maps and their integration (both kinds)."""

import numpy as np
import pytest
import torch
from scipy import signal

from benchmark.core import scene
from benchmark.reference import chain, detect, geometry, pipelines
from benchmark.reference.precision import FP32, TF32
from benchmark.tests import tiny

SCENE = dict(direct_gain=0.5, noise=0.001,
             clutter=[dict(delay_samples=2, amplitude=0.2)],
             targets=[dict(delay_samples=5, doppler_hz=20.0,
                           amplitude=0.05)])


def _params(over, config):
    return dict(tiny._load(f"{tiny.BENCH}/configs/{config}.json"), **over)


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("up,down,n", [(13, 119, 40_000), (1, 3, 9_001),
                                       (3, 17, 2_385)])
def test_resample_is_scipy_resample_poly_line(up, down, n):
    rng = np.random.default_rng(up)
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    want = signal.resample_poly(x, up, down, axis=1, padtype="line")
    got = chain.resample(torch.from_numpy(x), up, down).numpy()
    assert _err(got, want) < 1e-12


def test_firwin_and_window_are_scipy():
    assert np.allclose(chain.firwin(2381, 1 / 119, 5.0),
                       signal.firwin(2381, 1 / 119, window=("kaiser", 5.0)),
                       atol=1e-15)
    assert np.allclose(chain.kaiser_periodic(1000, 5.0),
                       signal.get_window(("kaiser", 5.0), 1000), atol=1e-15)


def _fm_ring(seed=3, frames=6):
    p = _params(tiny.FM, "fm_upstream")
    g = geometry.derive(p)
    ref, srv = scene.make_ring(g, SCENE, frames, seed, "cpu")
    return p, g, ref, srv


def test_fm_batch_chain_matches_the_port():
    from passiveradar_torch import derive_config, pipeline
    p, g, ref, srv = _fm_ring()
    cfg = derive_config(p)
    assert (cfg.cpi_samples, cfg.resamp_up, cfg.resamp_dn,
            cfg.num_range_cells, cfg.num_doppler_cells,
            cfg.input_chunk_length // 2) == (
        g["cpi_samples"], g["up"], g["down"], g["num_range_cells"],
        g["num_doppler_cells"], g["frame_len"])
    pairs = [scene.to_int16_pairs(x, g["int16_scale"]) for x in (ref, srv)]
    frames = list(range(ref.shape[0]))
    got = pipeline.process_frames(pairs[0], pairs[1],
                                  pipeline.frame_phases(cfg, frames), cfg,
                                  device="cpu").numpy()
    raw = [torch.from_numpy(x.astype(np.float64) * g["int16_scale"])
           for x in pairs]
    r, s = pipelines.fm_clean(*(torch.complex(x[..., 0], x[..., 1])
                                for x in raw), frames, g)
    want = pipelines.fm_maps(r, s, g).numpy()
    for f in frames:
        assert _err(got[f], want[f]) < 1e-4
        assert np.argmax(np.abs(got[f])) == np.argmax(np.abs(want[f]))


def test_stream_maps_cfar_and_tracker_match_the_port():
    from passiveradar_torch import derive_config
    from passiveradar_torch.streaming import StreamingProcessor
    p, g, ref, srv = _fm_ring(frames=10)
    cfg = derive_config(p)
    sp = StreamingProcessor(cfg, n_tracks=10, device="cpu")
    refc, srvc = (scene.to_complex64(x) for x in (ref, srv))
    frames = list(range(10))
    r, s = pipelines.fm_clean(torch.from_numpy(refc).to(torch.complex128),
                              torch.from_numpy(srvc).to(torch.complex128),
                              frames, g)
    want = pipelines.fm_maps(r, s, g).numpy()
    k_max = max(384, int(0.003 * g["num_doppler_cells"]
                         * (g["num_range_cells"] + 1)))
    table = detect.init_table(10)
    live = 0
    for f in frames:
        res = sp.push(refc[f], srvc[f])
        if res is None:
            continue
        i = res.frame_index
        assert _err(res.caf, want[i]) < 1e-4
        assert _err(res.cfar, detect.cfar(np.abs(want[i]), 18, 4)) < 1e-4
        table = detect.step(table, res.cfar, (g["max_doppler"],
                                               g["max_range"]), k_max)
        bad, err = detect.compare(res.tracks, table)
        assert bad == 0 and err < 1e-4
        live += int((table["status"] > 0).sum())
    assert live > 0


def test_tracker_step_matches_the_port_over_many_frames():
    """The reference's step against the port's plain step on frames with
    two moving targets and noise, every table of 40 frames."""
    from passiveradar_torch.detect import trackers
    rng = np.random.default_rng(5)
    nf, nr, extent, k_max = 256, 60, (128.0, 400.0), 384
    port = trackers.init_tracks(10, "cpu")
    table = detect.init_table(10)
    for t in range(40):
        frame = rng.exponential(1.0, (nf, nr))
        for d0, r0, v in ((100, 20, 1), (160, 40, -1)):
            frame[(d0 + v * t // 4) % nf, r0 + t // 8] += 400.0
        port = trackers.multitarget_step(port, torch.from_numpy(
            frame.astype(np.float32)), extent, 10, k_max)
        table = detect.step(table, frame.astype(np.float32), extent, k_max)
        bad, err = detect.compare(trackers.to_host(port), table)
        assert bad == 0 and err < 1e-4, t
    assert (table["status"] == 2).sum() >= 1


def test_cfar_matches_the_port():
    from passiveradar_torch.ops.cfar import cfar_2d
    x = np.random.default_rng(2).exponential(1.0, (64, 40)).astype(
        np.float32)
    got = cfar_2d(torch.from_numpy(x), 18, 4).numpy()
    assert _err(got, detect.cfar(x, 18, 4)) < 1e-5


def test_wideband_maps_and_integration_match_the_port():
    from passiveradar_torch import derive_config, wideband
    p = _params(tiny.WIDEBAND, "wideband_8ch")
    g = geometry.derive(p)
    cfg = derive_config(p)
    assert (cfg.cpi_samples, cfg.num_range_cells, cfg.num_doppler_cells) \
        == (g["cpi_samples"], g["num_range_cells"], g["num_doppler_cells"])
    ref, srv = scene.make_ring(g, SCENE, 2, 4, "cpu")
    refc, srvc = (scene.to_complex64(x) for x in (ref, srv))
    got = wideband.wideband_frames(refc, srvc, cfg, device="cpu")
    want = pipelines.wideband_maps(torch.from_numpy(refc).to(
        torch.complex128), torch.from_numpy(srvc).to(torch.complex128), g)
    assert _err(got.numpy(), want.numpy()) < 1e-4
    assert _err(wideband.integrate_channels(got[0]).numpy(),
                chain.integrate(want)[0].numpy()) < 1e-4


def test_control_is_the_lower_precision():
    """The control (TF32) reads far from the reference where float32 does
    not: the separation the cells' limits stand on, at a small size."""
    p, g, ref, srv = _fm_ring(frames=3)
    want = pipelines.fm_maps(*pipelines.fm_clean(ref, srv, [0, 1, 2], g), g)
    out = {}
    for prec in (FP32, TF32):
        r, s = pipelines.fm_clean(ref.to(torch.complex64),
                                  srv.to(torch.complex64), [0, 1, 2], g, prec)
        out[prec.name] = _err(pipelines.fm_maps(r, s, g, prec=prec).numpy(),
                              want.numpy())
    assert out["tf32"] > 30 * out["fp32"]
