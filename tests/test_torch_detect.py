"""The port's CFAR, candidate extraction, Kalman filter and multitarget
tracker step against the JAX package, on the CPU.

Tolerances: CFAR rtol 1e-5 (float32 sums of up to 324 terms in another
order); Kalman states atol 1e-5 (a few 4×4 float32 products on O(10)
values); candidates equal in their valid mask and strengths within 1e-6
relative, positions within 1e-5 (float32 linspace); the tracker step by step
with equal status, lifetime and history and estimates within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.detect import kalman as jk  # noqa: E402
from passiveradar_tpu.detect import trackers as jt  # noqa: E402
from passiveradar_tpu.detect.measurements import \
    get_measurements as j_meas  # noqa: E402
from passiveradar_tpu.ops.cfar import cfar_2d as j_cfar  # noqa: E402
from passiveradar_tpu.ops.cfar import cfar_kernel as j_kernel  # noqa: E402
from passiveradar_torch.detect import kalman as tk  # noqa: E402
from passiveradar_torch.detect import trackers as tt  # noqa: E402
from passiveradar_torch.detect.measurements import \
    get_measurements as t_meas  # noqa: E402
from passiveradar_torch.ops.cfar import cfar_2d as t_cfar  # noqa: E402
from passiveradar_torch.ops.cfar import cfar_kernel as t_kernel  # noqa: E402

# TINY's map geometry: 256 Doppler × 24 range cells
NF, NR = 256, 24
D_EXT, R_EXT = 128.0, 380.0


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _frame_with_targets(rng, targets, amp=60.0):
    """Raw pipeline-orientation frame (NF, NR) with point targets at
    (range km, Doppler Hz)."""
    x = (rng.random((NF, NR)) * 0.2 + 1.0).astype(np.float32)
    for r_km, d_hz in targets:
        k = int(round((1 - r_km / R_EXT) * (NR - 1)))
        j = int(round((d_hz + D_EXT) / (2 * D_EXT) * (NF - 1)))
        x[NF - 1 - j, k] = amp
    return x


# ---------------------------------------------------------------- CFAR

@pytest.mark.parametrize("fw,gw", [(18, 4), (9, 3), (5, 1)])
def test_cfar_kernel_equal(fw, gw):
    np.testing.assert_array_equal(t_kernel(fw, gw), j_kernel(fw, gw))


@pytest.mark.parametrize("shape", [(64, 40), (3, 32, 24), (NF, NR + 1)])
@pytest.mark.parametrize("fw,gw", [(18, 4), (9, 3)])
def test_cfar_2d_matches_jax(rng, shape, fw, gw):
    x = rng.random(shape).astype(np.float32) + 0.1
    want = np.array(j_cfar(x, fw, gw))
    got = t_cfar(torch.from_numpy(x), fw, gw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_cfar_2d_threshold_mode(rng):
    x = rng.random((32, 24)).astype(np.float32) + 0.1
    x[10, 7] = 40.0
    want = np.array(j_cfar(x, 9, 3, thresh=2.0))
    got = t_cfar(x, 9, 3, thresh=2.0)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[10, 7]


# ------------------------------------------------------- measurements

@pytest.mark.parametrize("k_max", [64, 384])
def test_get_measurements_matches_jax(rng, k_max):
    x = _frame_with_targets(rng, [(200.0, 40.0), (150.0, -60.0)])
    x = np.array(j_cfar(x, 18, 4))
    cand_j, valid_j = j_meas(jnp.asarray(x), jnp.asarray((D_EXT, R_EXT),
                                                         jnp.float32), k_max)
    cand_t, valid_t = t_meas(torch.from_numpy(x),
                             torch.tensor((D_EXT, R_EXT)), k_max)
    cand_j, valid_j = np.asarray(cand_j), np.asarray(valid_j)
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    assert valid_j.sum() >= 2
    np.testing.assert_allclose(cand_t[2].numpy(), cand_j[2], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(cand_t.numpy()[:2, valid_j],
                               cand_j[:2, valid_j], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- Kalman

def _kalman_cases():
    return [((10.0, -5.0), (11.0, -4.0), (10.0, -5.0)),
            ((150.0, 42.0), (148.5, 40.25), (151.0, 43.0)),
            ((0.0, 0.0), (3.0, -2.0), (3.0, -2.0))]


def test_default_kalman_state_equal():
    want = _np(jk.default_kalman_state(12.5, -3.0))
    got = _np(tk.default_kalman_state(12.5, -3.0))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("start,meas,last", _kalman_cases())
def test_kalman_functions_match_jax(start, meas, last):
    """kalman_update, adaptive_kalman_update and kalman_extrapolate, each
    twice in a row (the second from the first's state)."""
    m = np.asarray(meas, np.float32)
    lm = np.asarray(last, np.float32)
    js = jk.default_kalman_state(*start)
    ts = tk.default_kalman_state(*start)
    steps = [
        (lambda s: jk.kalman_update(jnp.asarray(m), s),
         lambda s: tk.kalman_update(torch.from_numpy(m), s)),
        (lambda s: jk.adaptive_kalman_update(jnp.asarray(m), jnp.asarray(lm),
                                             s),
         lambda s: tk.adaptive_kalman_update(torch.from_numpy(m),
                                             torch.from_numpy(lm), s)),
        (jk.kalman_extrapolate, tk.kalman_extrapolate),
    ]
    for jf, tf in steps:
        jst, tst = js, ts
        for _ in range(2):
            je, jst = jf(jst)
            te, tst = tf(tst)
            np.testing.assert_allclose(te.numpy(), np.asarray(je),
                                       atol=1e-5, rtol=1e-6)
            for k in ("x", "P", "S"):
                np.testing.assert_allclose(tst[k].numpy(),
                                           np.asarray(jst[k]), atol=1e-5,
                                           rtol=1e-6)


# ----------------------------------------------------------- trackers

def test_init_tracks_equal():
    want = _np(jt.init_tracks(5))
    got = _np(tt.init_tracks(5, device="cpu"))
    for k in ("status", "lifetime", "measurement", "estimate", "history"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for k in want["kalman"]:
        np.testing.assert_array_equal(got["kalman"][k], want["kalman"][k])


def _assert_tables_agree(got, want, where=""):
    for k in ("status", "lifetime", "history"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")
    for k in ("estimate", "measurement"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-6,
                                   err_msg=f"{k} {where}")
    for k in ("x", "P", "S"):
        np.testing.assert_allclose(got["kalman"][k], want["kalman"][k],
                                   atol=1e-4, rtol=1e-5,
                                   err_msg=f"kalman.{k} {where}")


@pytest.fixture(scope="module")
def tracker_run():
    """A TINY CFAR stack, 18 frames: a target moving in Doppler, a fixed
    one, and one that vanishes after frame 7 (its track coasts and dies),
    all in the range rows that get_measurements keeps (8 of 24);
    the JAX step's track table after each frame, computed once."""
    rng = np.random.default_rng(21)
    frames = []
    for t in range(18):
        tg = [(230.0, 30.0 + 0.5 * t), (170.0, -60.0)]
        if t < 8:
            tg.append((200.0, 90.0))
        frames.append(np.array(j_cfar(_frame_with_targets(rng, tg),
                                        18, 4)))
    extent = jnp.asarray((D_EXT, R_EXT), jnp.float32)
    tracks = jt.init_tracks(6)
    history = []
    for f in frames:
        tracks = jt.multitarget_step(tracks, jnp.asarray(f), extent, 6, 384)
        history.append(_np(tracks))
    return frames, history


def test_multitarget_step_matches_jax(tracker_run):
    frames, history = tracker_run
    extent = torch.tensor((D_EXT, R_EXT))
    tracks = tt.init_tracks(6, device="cpu")
    for i, f in enumerate(frames):
        before = _np(tracks)
        new = tt.multitarget_step(tracks, torch.from_numpy(f), extent, 6,
                                  384)
        # the step returns a new table and leaves its input as it was
        _assert_tables_agree(_np(tracks), before, f"input, frame {i}")
        tracks = new
        _assert_tables_agree(_np(tracks), history[i], f"frame {i}")
    # the scene exercised every state: two confirmed tracks at the end, and
    # the vanished target's track coasted and went back to free
    status = np.stack([h["status"] for h in history])
    assert (status[-1] == 2).sum() >= 2
    assert (status[8] == 1).all() and status[15, 2] == 0
