"""The port's entry points with the other clutter impls, a dense solver and
the flattop CAF, against the JAX package, on the CPU.

TINY geometry (tests/test_pipeline.py:23) with ``clutter_impl`` 'coupled'
or 'segment', ``clutter_solver: gs_dense`` and ``caf_short_filt: false``,
through ``process_frames``, ``cli.process`` and ``StreamingProcessor``, and
one wideband CPI (tests/test_wideband.py's geometry) with the flattop CAF.
Bounds: tests/test_torch_pipeline.py's TOL (1e-4 of the map peak, argmax
equal in every frame) with the Levinson solver, tests/test_torch_streaming.py's
for a push. With ``gs_dense`` the maps are held to the golden pipeline bound
(tests/test_golden_e2e.py:93-100: 2e-3 of the peak, argmax equal): TINY's
Toeplitz systems are ill-conditioned, so two float32 dense solvers that
round in another order (the port's and the JAX package's) give maps
further apart than 1e-4 of the peak, as the JAX package's own gs_dense
maps are from its Levinson maps.
"""

import dataclasses

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu import wideband as jwb  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.pipeline import \
    frame_phases as j_frame_phases  # noqa: E402
from passiveradar_tpu.pipeline import \
    process_frames as j_process_frames  # noqa: E402
from passiveradar_tpu.streaming import \
    StreamingProcessor as JSP  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch import streaming as ts  # noqa: E402
from passiveradar_torch import wideband as twb  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, write_synth_capture)
from tests.test_pipeline import TINY, _make_frames  # noqa: E402
from tests.test_torch_pipeline import _assert_maps_agree  # noqa: E402
from tests.test_torch_streaming import (  # noqa: E402
    _assert_result_agrees, _run)
from tests.test_wideband import WB, _wb_signals  # noqa: E402

ALT = [dict(clutter_impl=impl, clutter_solver="gs_dense",
            caf_short_filt=False) for impl in ("coupled", "segment")]
IDS = ["coupled", "segment"]
GOLDEN_TOL = 2e-3


def _assert_maps_within(got, want, tol):
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) < tol * np.max(np.abs(want))
    for f in range(want.shape[0]):
        assert (np.unravel_index(np.argmax(np.abs(got[f])), got[f].shape)
                == np.unravel_index(np.argmax(np.abs(want[f])),
                                    want[f].shape)), f


@pytest.mark.parametrize("solver,tol", [("levinson", 1e-4),
                                        ("gs_dense", GOLDEN_TOL)])
@pytest.mark.parametrize("impl", ["coupled", "segment"])
def test_process_frames_alt_matches_jax(impl, solver, tol):
    params = dict(TINY, clutter_impl=impl, clutter_solver=solver,
                  caf_short_filt=False)
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    n_frames = 4
    ref, srv = _make_frames(cfg_j, n_frames, (JTarget(40, 20.0, 0.1),),
                            seed=0)
    phases = j_frame_phases(cfg_j, list(range(n_frames)))
    want = np.asarray(j_process_frames(jnp.asarray(ref), jnp.asarray(srv),
                                       jnp.asarray(phases), cfg_j))
    got = tp.process_frames(ref, srv, phases, cfg_t, device="cpu").numpy()
    _assert_maps_within(got, want, tol)
    # the flattop maps are not the boxcar's: the option reached the CAF
    box = tp.process_frames(ref, srv, phases,
                            dataclasses.replace(cfg_t, caf_short_filt=True),
                            device="cpu").numpy()
    assert np.max(np.abs(box - got)) > 1e-2 * np.max(np.abs(got))


def _xambg(path):
    with h5py.File(path, "r") as f:
        return np.moveaxis(np.asarray(f["/xambg"]), 2, 0)


@pytest.mark.parametrize("alt", ALT, ids=IDS)
def test_cli_process_alt_matches_jax(tmp_path, alt):
    """Both CLIs on one 6-frame capture. run_capture feeds all-zero margin
    frames; the JAX package's gs_dense product overflows on them (NaN maps
    where they reach a frame through the halo) while the port's scaled
    product stays finite: every port frame is finite, and the frames that
    are finite in JAX agree within the golden bound."""
    from passiveradar_torch.cli.process import main as t_main
    from passiveradar_tpu.cli.process import main as j_main
    params = dict(TINY, num_frames=6, input_file=str(tmp_path / "cap.hdf5"),
                  **alt)
    write_synth_capture(params["input_file"], t_derive(params), 6,
                        targets=(Target(40, 20.0, 0.12),), channel_offset=3)
    for tag in ("T", "J"):
        p = dict(params, output_fname=str(tmp_path / f"XAMBG_{tag}"))
        (tmp_path / f"{tag}.yaml").write_text(yaml.safe_dump(p))
    assert t_main(["--config", str(tmp_path / "T.yaml"),
                   "--device", "cpu"]) == 6
    j_main(["--config", str(tmp_path / "J.yaml")])
    got = _xambg(str(tmp_path / "XAMBG_T.hdf5"))
    want = _xambg(str(tmp_path / "XAMBG_J.hdf5"))
    assert got.shape == want.shape and np.all(np.isfinite(got))
    finite = [f for f in range(6) if np.isfinite(want[f]).all()]
    assert len(finite) >= 4
    _assert_maps_within(got[finite], want[finite], GOLDEN_TOL)


@pytest.mark.parametrize("alt", ALT, ids=IDS)
def test_streaming_alt_matches_jax(alt):
    """Five pushes and a flush: each CAF within 1e-3 of the JAX processor's
    peak, the track tables equal."""
    params = dict(TINY, **alt)
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    ref, srv = _make_frames(cfg_j, 5, (JTarget(40, 20.0, 0.3),), seed=7)
    want = _run(JSP(cfg_j, n_tracks=4), ref, srv)
    got = _run(ts.StreamingProcessor(cfg_t, n_tracks=4, device="cpu"), ref,
               srv)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _assert_result_agrees(g, w)


def test_wideband_cpi_flattop_matches_jax():
    """One wideband CPI with the flattop CAF (the per-channel canceller is
    the default carry/levinson one whatever the config says, as in the JAX
    package)."""
    params = dict(WB, input_file="", output_fname="wb",
                  caf_short_filt=False, clutter_impl="segment")
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    ref, srv = _wb_signals(cfg_j, 1, np.random.default_rng(12345))
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    r1, s1 = ref.reshape(1, n), srv.reshape(1, n)
    want = np.asarray(jwb.wideband_frames(r1, s1, cfg_j))
    got = twb.wideband_frames(r1, s1, cfg_t, device="cpu").numpy()
    assert got.shape == want.shape
    for i in range(got.shape[1]):
        _assert_maps_agree(got[:, i], want[:, i])
