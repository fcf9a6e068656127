"""The multitarget tracker step over several channels and frames at once
(detect/tracker_kernel.py's contract, on the CPU through its plain version)
against the JAX package.

Scenes are tests/test_detect.py's (one target, two targets, coast-then-die,
as CFAR maps; the wideband echo of tests/test_torch_wideband.py), none on a
gate edge. On tests/test_torch_cuda.py's association scenes, which sit on
the association's edges (ties, one candidate, none valid, every status
mix), the plain step is held against the JAX package's _associate and
_track_transition, and a numpy transcription of the kernel's bitmask
association (csrc/tracker.cu) discretely equal to the plain step.
Tolerances, as tests/test_torch_detect.py: status, lifetime and history
exactly equal; estimates and measurements within atol 1e-4, rtol 1e-6; the
Kalman x, P, S within atol 1e-4, rtol 1e-5 (float32 4×4 products in
another order); candidates with equal valid masks, strengths within rtol
1e-6 and positions within 1e-5 (float32 linspace). The port against
itself (a stack against its frames, the channel table against a table a
channel) is exact.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu import wideband as jwb  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.detect import trackers as jt  # noqa: E402
from passiveradar_tpu.detect.measurements import \
    get_measurements as j_meas  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.ops.cfar import cfar_2d as j_cfar  # noqa: E402
from passiveradar_tpu.streaming import \
    StreamingProcessor as JSP  # noqa: E402
from passiveradar_torch import streaming as ts  # noqa: E402
from passiveradar_torch import wideband as twb  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.detect import measurements as tm  # noqa: E402
from passiveradar_torch.detect import tracker_kernel as trk  # noqa: E402
from passiveradar_torch.detect import trackers as tt  # noqa: E402
from tests.test_pipeline import TINY, _make_frames  # noqa: E402
from tests.test_torch_cuda import (  # noqa: E402
    ASSOCIATION_SCENES, _association_scenes)
from tests.test_torch_trackers import (  # noqa: E402
    D_EXT, R_EXT, _coast_then_die, _one_target, _two_targets)
from tests.test_torch_wideband import (  # noqa: E402
    STREAM_CPIS, TRACK_ECHO, TRACK_GEOMETRY, _cfgs)
from tests.test_wideband import _wb_signals  # noqa: E402

SCENES = (_one_target, _two_targets, _coast_then_die)
N_TRACKS, K_MAX = 6, 64
EXTENT = torch.tensor((D_EXT, R_EXT))
J_EXTENT = jnp.asarray((D_EXT, R_EXT), jnp.float32)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


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


def _assert_tables_equal(got, want, where=""):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tables_equal(got[k], want[k], f"{where} {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} {where}")


@pytest.fixture(scope="module")
def stacks():
    """(3, 25, 64, 40): a channel a scene, the CFAR maps (JAX's cfar_2d,
    (9, 3)) of its first 25 frames. CFAR makes equal target amplitudes
    unequal strengths: the top-k order of equal values is not the JAX
    package's."""
    rng = np.random.default_rng(12345)
    return np.stack([np.stack([np.asarray(j_cfar(f, 9, 3))
                               for f in make(rng)[:25]])
                     for make in SCENES])


# ----------------------------------------------------------- the step

def test_batched_step_matches_three_jax_runs(stacks):
    """multitarget_step on three channels at once, frame by frame, against
    three separate JAX multitarget_step runs; the input table is left as
    it was."""
    table = tt.init_tracks(N_TRACKS, "cpu", channels=3)
    jax_tables = [jt.init_tracks(N_TRACKS) for _ in SCENES]
    for t in range(stacks.shape[1]):
        before = tt.to_host(table)
        new = tt.multitarget_step(table, torch.from_numpy(stacks[:, t]),
                                  EXTENT, N_TRACKS, K_MAX)
        _assert_tables_equal(tt.to_host(table), before, f"input, frame {t}")
        table = new
        got = tt.to_host(table)
        assert got["status"].shape == (3, N_TRACKS)
        for c in range(3):
            jax_tables[c] = jt.multitarget_step(
                jax_tables[c], jnp.asarray(stacks[c, t]), J_EXTENT, N_TRACKS,
                K_MAX)
            _assert_tables_agree(tt._slot(got, c), _np(jax_tables[c]),
                                 f"channel {c}, frame {t}")
    status = tt.to_host(table)["status"]
    assert (status[0] == 2).any() and (status[1] == 2).sum() >= 2


def test_kernel_contract_frames_equal_steps(stacks):
    """multitarget_step_kernel over T frames (the plain version here) is,
    frame for frame, T single-frame steps of every channel."""
    frames = torch.from_numpy(stacks[:, :12])
    cand, valid = tm.get_measurements(frames, EXTENT, K_MAX)
    table = tt.init_tracks(N_TRACKS, "cpu", channels=3)
    hist = tt.to_host(trk.multitarget_step_kernel(table, cand, valid,
                                                  N_TRACKS))
    assert hist["kalman"]["P"].shape == (12, 3, N_TRACKS, 4, 4)
    for t in range(12):
        table = tt.multitarget_step(table, frames[:, t], EXTENT, N_TRACKS,
                                    K_MAX)
        _assert_tables_equal(tt._slot(hist, t), tt.to_host(table),
                             f"frame {t}")


# ------------------------------------------------------- the candidates

@pytest.mark.parametrize("axis", ["channels", "frames", "both"])
def test_batched_get_measurements_rows_equal_frames_and_jax(stacks, axis):
    """get_measurements on (C, nd, nr), (T, nd, nr) and (C, T, nd, nr)
    stacks: each row bit-equal to its frame's own call, and that call
    within the existing tolerance of JAX's."""
    x = dict(channels=stacks[:, 10], frames=stacks[1],
             both=stacks[:, :4])[axis]
    cand, valid = tm.get_measurements(torch.from_numpy(x), EXTENT, K_MAX)
    assert cand.shape == (*x.shape[:-2], 3, K_MAX)
    assert valid.shape == (*x.shape[:-2], K_MAX)
    frames = x.reshape(-1, *x.shape[-2:])
    cand, valid = cand.reshape(-1, 3, K_MAX), valid.reshape(-1, K_MAX)
    for i, frame in enumerate(frames):
        c1, v1 = tm.get_measurements(torch.from_numpy(frame), EXTENT, K_MAX)
        assert torch.equal(c1, cand[i]) and torch.equal(v1, valid[i]), i
        cj, vj = j_meas(jnp.asarray(frame), J_EXTENT, K_MAX)
        cj, vj = np.asarray(cj), np.asarray(vj)
        np.testing.assert_array_equal(v1.numpy(), vj)
        np.testing.assert_allclose(c1[2].numpy(), cj[2], rtol=1e-6, atol=0)
        np.testing.assert_allclose(c1.numpy()[:2, vj], cj[:2, vj],
                                   rtol=1e-5, atol=1e-5)


def test_get_measurements_takes_a_stack_beyond_quantile_limit():
    """A stack of more than 2^24 cells (torch.quantile's limit, which the
    threshold no longer goes through) in one call: its rows equal their
    frames' own calls."""
    rng = np.random.default_rng(4)
    x = (rng.random((260, 256, 256)) * 0.2 + 1.0).astype(np.float32)
    x[:, 40, 100] = 60.0
    assert x.size > 1 << 24
    cand, valid = tm.get_measurements(torch.from_numpy(x), EXTENT, K_MAX)
    for i in (0, 97, 259):
        c1, v1 = tm.get_measurements(torch.from_numpy(x[i]), EXTENT, K_MAX)
        assert torch.equal(c1, cand[i]) and torch.equal(v1, valid[i])
        assert v1[0]


@pytest.mark.parametrize("n", [25728, 181248, 1000, 2])
def test_percentile_ranks_are_the_sorted_neighbours(n):
    """The threshold's ranks and weights: neighbours in sorted order around
    99.8% of the way, weights summing to 1; on a random row the threshold
    they give is jnp.percentile's within float32 rounding."""
    low, high, lw, hw = tm._percentile_ranks(n, 99.8)
    assert 0 <= low <= high <= n - 1 and high - low <= 1
    assert lw + hw == 1.0 and 0 <= hw < 1
    x = np.random.default_rng(n).random(n, np.float32)
    s = np.sort(x)
    got = np.float32(s[low] * np.float32(lw)) + np.float32(
        s[high] * np.float32(hw))
    want = float(jnp.percentile(jnp.asarray(x), 99.8))
    assert s[low] <= got <= s[high]
    assert abs(got - want) <= 1e-6 * abs(want)


# ----------------------------------------------------- the batch tracker

@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_batch_tracker_is_its_frames_steps_and_jax(stacks, scene):
    """multitarget_tracker (every frame's candidates in one call, the stack
    in one kernel call) equal to stepping frame by frame, and against the
    JAX tracker."""
    data = stacks[scene]
    got = tt.to_host(tt.multitarget_tracker(data, (D_EXT, R_EXT), N_TRACKS,
                                            K_MAX, frames_last=False,
                                            device="cpu"))
    table = tt.init_tracks(N_TRACKS, "cpu")
    for t, frame in enumerate(data):
        table = tt.multitarget_step(table, torch.from_numpy(frame), EXTENT,
                                    N_TRACKS, K_MAX)
        _assert_tables_equal(tt._slot(got, t), tt.to_host(table),
                             f"frame {t}")
    want = _np(jt.multitarget_tracker(data, (D_EXT, R_EXT), N_TRACKS,
                                      k_max=K_MAX, frames_last=False))
    _assert_tables_agree(got, want)


@pytest.mark.parametrize("per_chunk", [1, 4])
def test_chunked_candidates_and_batch_tracker(stacks, monkeypatch,
                                              per_chunk):
    """A stack longer than one chunk of CHUNK_BYTES (forced small): its
    candidates bit-equal to the stack's in one chunk, for (T, nd, nr) and
    (C, T, nd, nr); multitarget_tracker's result unchanged and against the
    JAX tracker."""
    data = torch.from_numpy(stacks)
    whole = tm.get_measurements(data, EXTENT, K_MAX)
    one = tt.to_host(tt.multitarget_tracker(stacks[1], (D_EXT, R_EXT),
                                            N_TRACKS, K_MAX,
                                            frames_last=False, device="cpu"))
    monkeypatch.setattr(tm, "CHUNK_BYTES", per_chunk * stacks[0, 0].nbytes)
    assert stacks.shape[1] > per_chunk
    cand, valid = tm.get_measurements(data, EXTENT, K_MAX)
    assert torch.equal(cand, whole[0]) and torch.equal(valid, whole[1])
    cand, valid = tm.get_measurements(data[1], EXTENT, K_MAX)
    assert torch.equal(cand, whole[0][1]) and torch.equal(valid, whole[1][1])
    got = tt.to_host(tt.multitarget_tracker(stacks[1], (D_EXT, R_EXT),
                                            N_TRACKS, K_MAX,
                                            frames_last=False, device="cpu"))
    _assert_tables_equal(got, one)
    want = _np(jt.multitarget_tracker(stacks[1], (D_EXT, R_EXT), N_TRACKS,
                                      k_max=K_MAX, frames_last=False))
    _assert_tables_agree(got, want)


# ------------------------------------------------ the stream processors

def test_wideband_channel_table_matches_table_a_channel_and_jax(tmp_path):
    """The wideband stream's one table with a channel axis: every push's
    per-channel tables equal to a table a channel stepped on its own over
    the same CFAR frames, and within tolerance of the JAX processor's."""
    _, cfg_j, cfg_t = _cfgs(tmp_path, **TRACK_GEOMETRY)
    ref, srv = _wb_signals(cfg_j, STREAM_CPIS, np.random.default_rng(12345),
                           **TRACK_ECHO)
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    sp = twb.WidebandStreamingProcessor(cfg_t, n_tracks=4, device="cpu")
    jsp = jwb.WidebandStreamingProcessor(cfg_j, n_tracks=4)
    select = cfg_t.wideband_channel_select
    assert sp._tracks["status"].shape == (len(select), 4)
    own = {k: tt.init_tracks(4, "cpu") for k in select}
    for fr in range(STREAM_CPIS):
        chunk = (ref[fr * n:(fr + 1) * n], srv[fr * n:(fr + 1) * n])
        got, want = sp.push(*chunk), jsp.push(*chunk)
        for k in select:
            own[k] = tt.multitarget_step(
                own[k], torch.from_numpy(got[k].cfar), sp._extent, 4,
                cfg_t.candidate_budget)
            _assert_tables_equal(got[k].tracks, tt.to_host(own[k]),
                                 f"channel {k}, CPI {fr}")
            _assert_tables_agree(got[k].tracks, _np(want[k].tracks),
                                 f"channel {k}, CPI {fr}")
    assert all((got[k].tracks["status"] > 0).any() for k in select)


def test_stream_processors_warm_the_tracker_and_keep_their_tables(
        tmp_path, monkeypatch):
    """Each processor warms the tracker (a step on a scratch table) only
    when made on the card: on the CPU it makes no step when made. Warmed
    by hand, its own table is still init_tracks' and its pushes give what
    an unwarmed processor's give."""
    steps = []
    real = tt.multitarget_step

    def counting(tracks, frame, *a, **kw):
        steps.append(tuple(frame.shape))
        return real(tracks, frame, *a, **kw)

    # narrowband: TINY, one target
    cfg = t_derive(TINY)
    ref, srv = _make_frames(j_derive(TINY), 4, (JTarget(40, 20.0, 0.3),),
                            seed=7)
    monkeypatch.setattr(ts, "multitarget_step", counting)
    runs = []
    for warm in (True, False):
        steps.clear()
        sp = ts.StreamingProcessor(cfg, n_tracks=4, device="cpu")
        assert steps == []
        if warm:
            sp._warm()
            assert steps == [(cfg.num_doppler_cells,
                              cfg.num_range_cells + 1)]
        _assert_tables_equal(tt.to_host(sp._tracks),
                             tt.to_host(tt.init_tracks(4, "cpu")))
        runs.append([sp.push(ref[f], srv[f]) for f in range(4)][1:])
    for a, b in zip(*runs):
        _assert_tables_equal(a.tracks, b.tracks)

    # wideband: every selected channel in one scratch table
    _, cfg_j, cfg_w = _cfgs(tmp_path, **TRACK_GEOMETRY)
    select = cfg_w.wideband_channel_select
    wref, wsrv = _wb_signals(cfg_j, 2, np.random.default_rng(5),
                             **TRACK_ECHO)
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    monkeypatch.setattr(twb, "multitarget_step", counting)
    runs = []
    for warm in (True, False):
        steps.clear()
        sp = twb.WidebandStreamingProcessor(cfg_w, n_tracks=4, device="cpu")
        assert steps == []
        if warm:
            sp._warm()
            assert steps == [(len(select), cfg_w.num_doppler_cells,
                              cfg_w.num_range_cells + 1)]
        _assert_tables_equal(tt.to_host(sp._tracks), tt.to_host(
            tt.init_tracks(4, "cpu", len(select))))
        runs.append(sp.push(wref[:n], wsrv[:n]))
    for k in select:
        _assert_tables_equal(runs[0][k].tracks, runs[1][k].tracks)
    # the JAX processor's first pushes, as a check that warming changed
    # nothing against the reference either
    want = JSP(j_derive(TINY), n_tracks=4)
    got = ts.StreamingProcessor(cfg, n_tracks=4, device="cpu")
    got._warm()
    for f in range(3):
        w, g = want.push(ref[f], srv[f]), got.push(ref[f], srv[f])
        if w is not None:
            _assert_tables_agree(g.tracks, _np(w.tracks), f"frame {f}")


# ------------------------------------------- the kernel's association

def _words(bits: np.ndarray, wpl: int) -> np.ndarray:
    """A (K,) bool set as the kernel's lane-major bitmask: candidate
    k = 1024 q + 32 b + l is bit b of word [q, l]."""
    w = np.zeros((wpl, 32), np.uint32)
    for k in np.flatnonzero(bits):
        w[k // 1024, k % 32] |= np.uint32(1 << (k // 32 % 32))
    return w


def _members(w: np.ndarray, lane: int):
    """The candidates of one lane's words, in increasing order."""
    return [1024 * q + 32 * b + lane for q in range(w.shape[0])
            for b in range(32) if w[q, lane] >> np.uint32(b) & 1]


def _first(w: np.ndarray) -> int:
    """The lowest candidate of a set: each lane's first member, then the
    least over the lanes (__ffs, __reduce_min_sync)."""
    firsts = [m[0] for m in (_members(w, lane) for lane in range(32)) if m]
    return min(firsts)


def _bitmask_associate(table, cand, valid):
    """csrc/tracker.cu's association for one channel and frame (its phases
    a–d), in numpy: the order by rank; every tracked slot's gate and early
    gate as masks; the chain over the pool's words (a tracked slot keeps
    gate AND pool and drops its early gate if that set is not empty; a
    free slot counts the pool, takes its first member, and drops what lies
    within 10 / 12 of it, or, with one member, everything); then each
    tracked slot's choice from the set it kept: the first, or the nearest
    to the origin by each lane's (distance, index) minimum and a least
    distance, then a least index, over the lanes. Returns found (N,) and
    the chosen measurement (N, 2), NaN where nothing was found."""
    f32 = np.float32
    status = table["status"]
    n, k = len(status), cand.shape[1]
    r, d = cand[0], cand[1]
    wpl = -(-k // 1024)
    prio = np.where(status == 2, 0, np.where(status == 1, 1, 2))
    rank = [sum(int(prio[j] < prio[i] or (prio[j] == prio[i] and j < i))
                for j in range(n)) for i in range(n)]
    order = np.empty(n, int)
    order[rank] = np.arange(n)
    gate, early = {}, {}
    for i in np.flatnonzero(status != 0):
        lm, le = table["measurement"][i], table["estimate"][i]
        if status[i] == 1:
            e = (np.abs(r - lm[0]) < f32(5)) & (np.abs(d - lm[1]) < f32(24))
            g = e
        else:
            e = (np.abs(r - le[0]) < f32(4)) & (np.abs(d - le[1]) < f32(20))
            (s00, s01), (s10, s11) = table["kalman"]["S"][i]
            det = s00 * s11 - s01 * s10
            i00, i01, i10, i11 = s11 / det, -s01 / det, -s10 / det, \
                s00 / det
            zr, zd = lm[0] - r, lm[1] - d
            m2 = zr * (i00 * zr + i01 * zd) + zd * (i10 * zr + i11 * zd)
            g = e & (m2 < f32(6))
        gate[i], early[i] = _words(g, wpl), _words(e, wpl)
    pool = _words(valid, wpl)
    found = np.zeros(n, bool)
    meas = np.full((n, 2), np.nan, np.float32)
    for i in order:
        if status[i] != 0:
            gate[i] = gate[i] & pool
            found[i] = gate[i].any()
            if found[i]:
                pool &= ~early[i]
            continue
        count = sum(bin(int(x)).count("1") for x in pool.ravel())
        found[i] = count > 0
        if not found[i]:
            continue
        choice = _first(pool)
        meas[i] = r[choice], d[choice]
        if count == 1:
            pool[:] = 0
            continue
        for lane in range(32):
            for j in _members(pool, lane):
                if np.abs(r[j] - meas[i, 0]) < f32(10) and \
                        np.abs(d[j] - meas[i, 1]) < f32(12):
                    pool[j // 1024, lane] &= ~np.uint32(1 << (j // 32 % 32))
    for i in np.flatnonzero(found & (status != 0)):
        if status[i] == 2:
            choice = _first(gate[i])
        else:
            best = []
            for lane in range(32):
                m = _members(gate[i], lane)
                if m:
                    dist = np.sqrt(r[m] * r[m] + d[m] * d[m])
                    j = int(np.argmin(dist))         # first of its least
                    best.append((dist[j].view(np.uint32), m[j]))
            least = min(key for key, _ in best)
            choice = min(j for key, j in best if key == least)
        meas[i] = r[choice], d[choice]
    return found, meas


def _next_status(table, found):
    """The status each slot takes (_track_transition's rules on the
    pre-update history and lifetime)."""
    status, hist = table["status"], table["history"]
    old = table["lifetime"] > 4
    s10, s20 = hist[:, :10].sum(1), hist.sum(1)
    prelim = np.where(old & (s10 < 6), 0, np.where(old & (s10 > 8), 2, 1))
    conf = np.where(old & (s20 < 4), 0, 2)
    return np.where(status == 0, np.where(found, 1, 0),
                    np.where(status == 1, prelim, conf))


@pytest.mark.parametrize("scene", ASSOCIATION_SCENES)
def test_bitmask_association_equals_plain_step(scene):
    """The transcription on every channel and frame of the scene, each
    frame from the table the plain step left: the plain step's statuses,
    its found flags (a free slot turning preliminary, a live slot's newest
    history entry) and its chosen measurements, exactly."""
    table, cand, valid, n = _association_scenes()[scene]
    hist = tt.to_host(tt.multitarget_step_plain(table, cand, valid, n))
    start = tt.to_host(table)
    n_found = 0
    for c in range(cand.shape[0]):
        for t in range(cand.shape[1]):
            where = f"{scene}: channel {c}, frame {t}"
            before = tt._slot(start if t == 0 else tt._slot(hist, t - 1), c)
            after = tt._slot(tt._slot(hist, t), c)
            found, meas = _bitmask_associate(before, cand[c, t].numpy(),
                                             valid[c, t].numpy())
            np.testing.assert_array_equal(
                after["status"], _next_status(before, found), err_msg=where)
            live = before["status"] != 0
            np.testing.assert_array_equal(
                found[live], after["history"][live, 0] == 1, err_msg=where)
            np.testing.assert_array_equal(
                found[~live], after["status"][~live] == 1, err_msg=where)
            np.testing.assert_array_equal(
                meas[found], after["measurement"][found], err_msg=where)
            n_found += int(found.sum())
    if scene == "all_invalid":
        assert n_found == 0
    else:
        assert n_found > 0


def test_bitmask_association_breaks_ties_by_index():
    """In the ties scene the preliminary slot takes candidate 2, the least
    index of four at distance 5 (2, 8, 33 and 40, in lanes 2, 8, 1 and 8),
    and the one-candidate scene's first free slot empties the pool."""
    table, cand, valid, _ = _association_scenes()["ties"]
    found, meas = _bitmask_associate(tt.to_host(tt._slot(table, 0)),
                                     cand[0, 0].numpy(), valid[0, 0].numpy())
    assert found[0]
    np.testing.assert_array_equal(meas[0], cand[0, 0, :2, 2].numpy())
    table, cand, valid, _ = _association_scenes()["one_candidate"]
    found, meas = _bitmask_associate(tt.to_host(tt._slot(table, 0)),
                                     cand[0, 0].numpy(), valid[0, 0].numpy())
    assert found.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(meas[0], cand[0, 0, :2, 17].numpy())


@functools.partial(jax.jit, static_argnames="n")
def _jax_frame(tracks, cand, valid, n):
    """JAX multitarget_step's slot loop on given candidates: the slots in
    its order (confirmed, preliminary, free, by slot), each through
    _associate on the pool its predecessors left, then _track_transition.
    Returns the table and each slot's found flag."""
    prio = jnp.where(tracks["status"] == 2, 0,
                     jnp.where(tracks["status"] == 1, 1, 2))
    order = jnp.argsort(prio * n + jnp.arange(n))

    def body(carry, s):
        trks, avail = carry
        i = order[s]
        tr = jax.tree.map(lambda a: a[i], trks)
        meas, found, avail = jt._associate(tr, cand, avail)
        new = jt._track_transition(tr, meas, found)
        trks = jax.tree.map(lambda a, v: a.at[i].set(v), trks, new)
        return (trks, avail), found

    (tracks, _), found = jax.lax.scan(body, (tracks, valid), jnp.arange(n))
    return tracks, jnp.zeros(n, bool).at[order].set(found)


@pytest.mark.parametrize("scene", ASSOCIATION_SCENES)
def test_plain_step_association_matches_jax(scene):
    """The plain step against the JAX package's _associate and
    _track_transition on every channel and frame of each association
    scene (distance ties, one candidate, every candidate invalid, the 27
    status mixes, K < 32 and not a multiple of 32, 8 channels over 16
    frames), each frame from the table the plain step left: its found flags
    (a free slot turning preliminary, a live slot's newest history entry),
    statuses and chosen measurements exactly, the whole table within this
    file's tolerances."""
    table, cand, valid, n = _association_scenes()[scene]
    hist = tt.to_host(tt.multitarget_step_plain(table, cand, valid, n))
    start = tt.to_host(table)
    n_found = 0
    for c in range(cand.shape[0]):
        for t in range(cand.shape[1]):
            where = f"{scene}: channel {c}, frame {t}"
            before = tt._slot(start if t == 0 else tt._slot(hist, t - 1), c)
            after = tt._slot(tt._slot(hist, t), c)
            want, found = _jax_frame(
                jax.tree.map(jnp.asarray, before), jnp.asarray(cand[c, t]),
                jnp.asarray(valid[c, t]), n)
            want, found = _np(want), np.asarray(found)
            live = before["status"] != 0
            np.testing.assert_array_equal(
                found[live], after["history"][live, 0] == 1, err_msg=where)
            np.testing.assert_array_equal(
                found[~live], after["status"][~live] == 1, err_msg=where)
            np.testing.assert_array_equal(after["status"], want["status"],
                                          err_msg=where)
            np.testing.assert_array_equal(
                after["measurement"][found], want["measurement"][found],
                err_msg=where)
            _assert_tables_agree(after, want, where)
            n_found += int(found.sum())
    if scene == "all_invalid":
        assert n_found == 0
    else:
        assert n_found > 0


# ------------------------------------------------------- the wrapper

def _inputs(c=2, t=3, k=16, n=4):
    rng = np.random.default_rng(9)
    cand = np.stack([rng.random((c, t, k)) * 100, rng.random((c, t, k)) * 60
                     - 30, np.sort(rng.random((c, t, k)))[..., ::-1]], 2)
    cand = torch.from_numpy(cand.astype(np.float32))
    valid = torch.from_numpy(rng.random((c, t, k)) < 0.7)
    return tt.init_tracks(n, "cpu", c), cand, valid


def _no_library():
    pytest.fail("a CPU call loaded the kernel's library")


def _replace(table, path, leaf):
    out = tt._map(lambda a: a, table)
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = leaf
    return out


@pytest.mark.parametrize("case", [
    "cand_dtype", "cand_shape", "valid_dtype", "valid_shape",
    "status_dtype", "leaf_shape", "n_tracks", "p_not_contiguous",
    "cand_not_contiguous", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, case):
    """Dtype, shape, contiguity and size are checked before any launch,
    so on the CPU too, and the library is never loaded for it."""
    monkeypatch.setattr(trk, "_library", _no_library)
    table, cand, valid = _inputs()
    n = 4
    if case == "cand_dtype":
        cand = cand.double()
    elif case == "cand_shape":
        cand = cand[:, :, :2]
    elif case == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif case == "valid_shape":
        valid = valid[:, :2]
    elif case == "status_dtype":
        table = _replace(table, ("status",), table["status"].long())
    elif case == "leaf_shape":
        table = _replace(table, ("kalman", "H"),
                         table["kalman"]["H"][..., :3].contiguous())
    elif case == "n_tracks":
        n = 5
    elif case == "p_not_contiguous":
        table = _replace(table, ("kalman", "P"),
                         table["kalman"]["P"].transpose(-1, -2))
    elif case == "cand_not_contiguous":
        cand = cand.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "empty":
        cand, valid = cand[:, :0], valid[:, :0]
    with pytest.raises(ValueError):
        trk.multitarget_step_kernel(table, cand, valid, n)


@pytest.mark.parametrize("edge,want", [(0, 0), (1, 1), (273, 273),
                                       (4095, 4095), (4096, 4096)])
def test_largest_finds_the_edge_of_a_monotone_test(edge, want):
    """_largest(fits, most): the largest n in 1…most with fits(n), 0 when
    none fits, most when all do."""
    assert trk._largest(lambda n: n <= edge, 4096) == want


class _StandInLibrary:
    """A library whose launch for K candidates and N slots asks for
    100·N + K bytes (-1 above K = 32768) of a 10,000-byte limit."""

    def tracker_smem_bytes(self, k, n):
        return -1 if k > 32768 else 100 * n + k

    def tracker_smem_optin(self, device):
        return 10_000


def test_size_check_names_the_limits(monkeypatch):
    """Before a launch, the wrapper's size check passes what the card's
    shared memory holds and raises ValueError otherwise, naming the most
    tracks at the call's K and the most K at its n_tracks."""
    monkeypatch.setattr(trk, "_library", _StandInLibrary)
    trk._check_fits.cache_clear()
    try:
        assert trk.shared_memory_limits(540, 10, 0) == dict(
            bytes=1540, optin_bytes=10_000, most_tracks=94, most_k=9000)
        trk._check_fits(540, 94, 0)
        trk._check_fits(9000, 10, 0)
        for k, n in ((540, 95), (9001, 10), (40000, 1)):
            with pytest.raises(ValueError, match="at most"):
                trk._check_fits(k, n, 0)
        with pytest.raises(ValueError, match="at K=540 it takes at most 94 "
                           "tracks, at n_tracks=95 at most K=500"):
            trk._check_fits(540, 95, 0)
    finally:
        trk._check_fits.cache_clear()


def test_cpu_tables_take_the_plain_version_without_the_library(monkeypatch):
    """On CPU tensors the wrapper, the step and the batch tracker run the
    plain version: no library, no launch counted."""
    monkeypatch.setattr(trk, "_library", _no_library)
    launches = trk.multitarget_step_kernel.launches
    table, cand, valid = _inputs()
    got = trk.multitarget_step_kernel(table, cand, valid, 4)
    _assert_tables_equal(tt.to_host(got), tt.to_host(
        tt.multitarget_step_plain(table, cand, valid, 4)))
    frames = torch.rand((2, 64, 40))
    tt.multitarget_step(table, frames, EXTENT, 4, K_MAX)
    tt.multitarget_tracker(frames, (D_EXT, R_EXT), 4, K_MAX,
                           frames_last=False, device="cpu")
    assert trk.multitarget_step_kernel.launches == launches


def test_kernel_record_layout_matches_the_wrapper():
    """csrc/tracker.cu's word offsets of a slot's record follow LEAVES, and
    the fresh-track record is make_track's at (0, 0)."""
    with open(trk.cuda_build.source_path("tracker")) as fh:
        src = fh.read()
    offsets = dict((k, int(v)) for k, v in
                   re.findall(r"\b(W_[A-Z0-9]+|WORDS) = (\d+)", src))
    names = ("W_STATUS", "W_LIFETIME", "W_MEAS", "W_EST", "W_HIST", "W_X",
             "W_P", "W_F1", "W_F2", "W_Q", "W_H", "W_R", "W_S")
    start = 0
    for name, (_, trail, _) in zip(names, trk.LEAVES):
        assert offsets[name] == start, name
        start += int(np.prod(trail, dtype=int))
    assert offsets["WORDS"] == start == 110
    record = trk._record(tt.make_track(torch.tensor([3.5, -2.0])))
    want = trk._fresh(torch.device("cpu")).clone().view(torch.float32)
    want[[2, 4, 26]] = 3.5      # measurement, estimate and x at the track
    want[[3, 5, 28]] = -2.0
    assert torch.equal(want.view(torch.int32), record)
