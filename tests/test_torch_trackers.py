"""The port's batch trackers (multitarget and single-target) against the JAX
package, on the CPU.

Scenes are those of tests/test_detect.py (one target, two targets, the
reference file layout, coast-then-die; the simple tracker's lock, loss and
strict reference-oracle scenes), none on a gate edge. Tolerances, as in
tests/test_torch_detect.py: discrete state (status, lifetime, history,
lock mode, meas_idx) exactly equal; estimates and measurements within atol
1e-4; Kalman states within atol 1e-4, rtol 1e-5 (float32 4×4 products in
another order, repeated over the frames). Against the strict reference-loop
oracle the tolerances are tests/test_detect.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.detect import trackers as jt  # noqa: E402
from passiveradar_torch.detect import trackers as tt  # noqa: E402
from passiveradar_torch.detect.trackers import to_host  # noqa: E402
from tests.test_detect import (  # noqa: E402
    _frame_with_target, _simple_strict_oracle)

D_EXT, R_EXT = 32.0, 100.0


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _noise(rng, nf, nr):
    return (rng.random((nf, nr)) * 0.2 + 1.0).astype(np.float32)


def _one_target(rng):
    nf, nr = 64, 40
    return np.stack([_frame_with_target(rng, nf, nr, 60.0 - 0.5 * t, 8.0,
                                        D_EXT, R_EXT) for t in range(30)])


def _two_targets(rng):
    nf, nr = 64, 40
    return np.stack([np.maximum(
        _frame_with_target(rng, nf, nr, 70.0, 12.0, D_EXT, R_EXT),
        _frame_with_target(rng, nf, nr, 30.0, -15.0, D_EXT, R_EXT))
        for _ in range(25)])


def _coast_then_die(rng):
    nf, nr = 64, 40
    frames = [_frame_with_target(rng, nf, nr, 55.0, 10.0, D_EXT, R_EXT)
              for _ in range(20)]
    frames += [_noise(rng, nf, nr) for _ in range(30)]
    return np.stack(frames)


def _reference_layout(rng):
    return rng.random((64, 40, 6)).astype(np.float32)


# (scene, n_tracks, k_max, frames_last)
MULTI_SCENES = {
    "one_target": (_one_target, 5, 64, False),
    "two_targets": (_two_targets, 6, 64, False),
    "reference_layout": (_reference_layout, 3, 32, None),
    "coast_then_die": (_coast_then_die, 4, 64, False),
}


def _assert_history_agrees(got, want):
    for k in ("status", "lifetime", "history"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    for k in ("estimate", "measurement"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-6,
                                   err_msg=k)
    for k in ("x", "P", "S"):
        np.testing.assert_allclose(got["kalman"][k], want["kalman"][k],
                                   atol=1e-4, rtol=1e-5, err_msg=f"kalman.{k}")


@pytest.mark.parametrize("scene", sorted(MULTI_SCENES))
def test_multitarget_tracker_matches_jax(scene):
    make, n_tracks, k_max, frames_last = MULTI_SCENES[scene]
    data = make(np.random.default_rng(12345))
    want = _np(jt.multitarget_tracker(data, (D_EXT, R_EXT), n_tracks,
                                      k_max=k_max, frames_last=frames_last))
    got = to_host(tt.multitarget_tracker(data, (D_EXT, R_EXT), n_tracks,
                                         k_max=k_max, frames_last=frames_last,
                                         device="cpu"))
    n_frames = data.shape[0] if frames_last is False else data.shape[2]
    assert got["status"].shape == (n_frames, n_tracks)
    assert got["kalman"]["P"].shape == (n_frames, n_tracks, 4, 4)
    _assert_history_agrees(got, want)
    if scene != "reference_layout":
        assert (got["status"] == 2).any(), "the scene confirmed no track"


def test_orient_stack_ambiguity_is_an_error():
    """A frame count rivalling the map dimensions raises in both batch
    trackers, as in JAX; an explicit orientation always works."""
    rng = np.random.default_rng(3)
    frames = rng.random((50, 64, 40)).astype(np.float32)
    for pkg in (jt, tt):
        kw = {} if pkg is jt else dict(device="cpu")
        with pytest.raises(ValueError, match="frames_last"):
            pkg.multitarget_tracker(frames, (32.0, 100.0), n_tracks=3,
                                    k_max=32, **kw)
        with pytest.raises(ValueError, match="frames_last"):
            pkg.simple_target_tracker(rng.random((64, 11, 75)), 100.0, 32.0,
                                      **kw)
    hist = tt.multitarget_tracker(frames, (32.0, 100.0), n_tracks=3,
                                  k_max=32, frames_last=False, device="cpu")
    assert tuple(hist["status"].shape) == (50, 3)
    got = tt._orient_stack(frames[:4], None, "cpu")      # frames first
    np.testing.assert_array_equal(got.numpy(), frames[:4])
    got = tt._orient_stack(np.moveaxis(frames[:4], 0, 2), None, "cpu")
    np.testing.assert_array_equal(got.numpy(), frames[:4])
    with pytest.raises(ValueError, match="3-D"):
        tt._orient_stack(frames[0], True, "cpu")


def _locks(rng):
    nf, nr = 64, 48
    return np.stack([_frame_with_target(rng, nf, nr, 50.0, 6.0, D_EXT, R_EXT,
                                        amp=100.0) for _ in range(30)])


def _locks_then_loses(rng):
    nf, nr = 64, 48
    frames = [_frame_with_target(rng, nf, nr, 50.0, 6.0, D_EXT, R_EXT,
                                 amp=100.0) for _ in range(20)]
    frames += [_noise(rng, nf, nr) for _ in range(20)]
    return np.stack(frames)


def _strict_scene(rng):
    """tests/test_detect.py's strict-oracle scene on the reference's
    ~300×512 geometry: a target at row 12 (the empty-gate quirk fires),
    then at row 60 (valid gates), and a decoy in the zeroed cols 250:260;
    (nf, nr, F) layout."""
    nf, nr = 512, 300
    rows = [12] * 7 + [60] * 8
    data = (0.2 + rng.random((nf, nr, len(rows))) * 0.5).astype(np.float32)
    for i, r in enumerate(rows):
        data[nf - 1 - 300, r, i] = 50.0
        data[nf - 1 - 255, 100, i] = 100.0
    return data


def _assert_simple_agrees(got, want):
    for k in ("lock_mode", "meas_idx"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    for k in ("estimate", "measurement"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-6,
                                   err_msg=k)
    for k in ("x", "P", "S"):
        np.testing.assert_allclose(got["kalman"][k], want["kalman"][k],
                                   atol=1e-4, rtol=1e-5, err_msg=f"kalman.{k}")


# (scene, range extent, Doppler extent, frames_last)
SIMPLE_SCENES = {
    "locks": (_locks, R_EXT, D_EXT, False),
    "locks_then_loses": (_locks_then_loses, R_EXT, D_EXT, False),
    "reference_geometry": (_strict_scene, 375.0, 256.0 / 1.092, True),
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("scene", sorted(SIMPLE_SCENES))
def test_simple_target_tracker_matches_jax(scene, strict):
    make, r_ext, d_ext, frames_last = SIMPLE_SCENES[scene]
    data = make(np.random.default_rng(12345))
    want = _np(jt.simple_target_tracker(jnp.asarray(data), r_ext, d_ext,
                                        frames_last=frames_last,
                                        strict=strict))
    got = to_host(tt.simple_target_tracker(data, r_ext, d_ext,
                                           frames_last=frames_last,
                                           strict=strict, device="cpu"))
    _assert_simple_agrees(got, want)
    if scene == "locks":
        assert got["lock_mode"][-1, 2] == 1


def test_simple_target_tracker_strict_matches_reference_oracle():
    """strict=True is frame-for-frame the reference loop (the numpy oracle
    of tests/test_detect.py), the negative-index empty-gate quirk and the
    literal cols-250:260 zeroing included."""
    data = _strict_scene(np.random.default_rng(12345))
    got = to_host(tt.simple_target_tracker(data, 375.0, 256.0 / 1.092,
                                           frames_last=True, strict=True,
                                           device="cpu"))
    want = _simple_strict_oracle(data, 375.0, 256.0 / 1.092)
    for i, (wl, wm, wi, we) in enumerate(want):
        np.testing.assert_array_equal(got["lock_mode"][i], wl,
                                      err_msg=f"frame {i}")
        assert tuple(got["meas_idx"][i]) == wi, i
        np.testing.assert_allclose(got["measurement"][i], wm, atol=1e-3)
        np.testing.assert_allclose(got["estimate"][i], we, atol=2e-2)
    idx = [tuple(v) for v in got["meas_idx"]]
    assert (0, 0) in idx, "the empty-gate quirk did not fire"
    assert any(w[0][2] == 1 and idx[i] == (60, 300)
               for i, w in enumerate(want)), "no fully locked gated frame"


@pytest.mark.parametrize("idx,half,n", [(30, 24, 300), (12, 24, 300),
                                        (0, 16, 40), (290, 24, 300),
                                        (24, 24, 300), (5, 48, 50)])
def test_py_slice_mask_is_python_slicing(idx, half, n):
    """The strict gate selects exactly what a[idx-half : idx+half] selects
    on a length-n axis (negative starts wrap, an empty slice selects
    nothing)."""
    coords = torch.arange(n)
    got = tt._py_slice_mask(coords, torch.tensor(idx), half, n).numpy()
    want = np.zeros(n, bool)
    want[np.arange(n)[idx - half:idx + half]] = True
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jt._py_slice_mask(jnp.arange(n), jnp.int32(idx),
                                        half, n))
    np.testing.assert_array_equal(got, jgot)
