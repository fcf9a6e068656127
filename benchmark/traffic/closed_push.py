"""Traffic kind ``closed_push``: one caller pushing frames through the port's
streaming processor in a closed loop, each push waiting for its result.

The mix's parameters: ``ring_frames`` distinct frames in a host ring,
``scene`` (core/scene.py), ``n_tracks``, ``cfar_kernel``, ``detail``,
``kept_maps`` (the pushes whose CAF maps and CFAR frames are kept for the
check) and ``kept_steps`` (the pushes whose tracker step is kept), each
``{"first": n, "sampled": m}``: the first n results and a uniform sample
of m of the rest, drawn from the seed. Push p feeds ring slot p mod
``ring_frames`` as frame p. Each push is one frame's complex64 chunk a
channel from host numpy, as ``cli.stream``'s reader hands it.

FM: ``streaming.StreamingProcessor`` (its result is the previous frame's:
the 50% CPI overlap needs the next frame's head). Wideband:
``wideband.WidebandStreamingProcessor`` (one push a CPI, every selected
channel, its result at once).

End-to-end metric ``push_ms_p50``: the median latency of every push of
the window, from the call to the return of its result on the host (its
95th and 99th percentiles and maximum are printed as a note). The
check compares the kept maps and CFAR frames with the reference, and
follows the tracker one step at each kept step: from the table the
program returned with the push before (a fresh table at the stream's
first result) on the program's CFAR frame of that push, comparing the
table the program returned. What is kept is copied after the push's clock
has stopped.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.core import scene as scenes
from benchmark.reference import chain, detect, geometry, pipelines
from benchmark.reference.precision import FP64, Precision


@dataclasses.dataclass
class State:
    cell: object
    g: dict
    ring_ref: np.ndarray
    ring_srv: np.ndarray
    seed: int
    device: torch.device
    proc: object = None
    first: int = 0                 # the window's first result
    # push → {channel: (CAF maps, CFAR frame)}
    maps: dict = dataclasses.field(default_factory=dict)
    # push → {channel: (table before, CFAR frame, table after)}
    steps: dict = dataclasses.field(default_factory=dict)
    push_ms: list = dataclasses.field(default_factory=list)


class Reservoir:
    """The first ``first`` items offered, and a uniform sample of
    ``sampled`` of the rest (reservoir sampling), drawn from ``rng``."""

    def __init__(self, first: int, sampled: int, rng):
        self.first, self.size, self.rng = first, sampled, rng
        self.items: dict = {}
        self.sample: list = []
        self.seen = 0

    def offer(self, key, make) -> None:
        """Keep ``make()`` under ``key`` if the sample takes it."""
        j = self.seen - self.first
        self.seen += 1
        if j < 0:
            self.items[key] = make()
        elif len(self.sample) < self.size:
            self.sample.append(key)
            self.items[key] = make()
        else:
            slot = int(self.rng.integers(j + 1))
            if slot < self.size:
                self.items.pop(self.sample[slot])
                self.sample[slot] = key
                self.items[key] = make()


def _wideband(g) -> bool:
    return bool(g["channels"])


def make_inputs(cell, seed: int, device):
    g = geometry.derive(cell.config)
    ref, srv = scenes.make_ring(g, cell.mix["scene"],
                                cell.mix["ring_frames"], seed, device)
    return scenes.to_complex64(ref), scenes.to_complex64(srv)


def _processor(state: State):
    from passiveradar_torch import derive_config
    cfg = derive_config(state.cell.config)
    mix = state.cell.mix
    kw = dict(n_tracks=mix["n_tracks"], cfar_kernel=tuple(mix["cfar_kernel"]),
              detail=mix["detail"], device=state.device)
    if _wideband(state.g):
        from passiveradar_torch.wideband import WidebandStreamingProcessor
        return WidebandStreamingProcessor(cfg, **kw)
    from passiveradar_torch.streaming import StreamingProcessor
    return StreamingProcessor(cfg, **kw)


def _push(state: State, p: int):
    r = state.ring_ref.shape[0]
    return state.proc.push(state.ring_ref[p % r], state.ring_srv[p % r])


def _channels(result, wideband: bool) -> dict:
    """{channel: its result}."""
    return dict(result) if wideband else {0: result}


def _copy(table: dict) -> dict:
    return {k: _copy(v) if isinstance(v, dict) else np.array(v)
            for k, v in table.items()}


def setup(cell, inputs, device, seed: int) -> State:
    g = geometry.derive(cell.config)
    state = State(cell, g, *inputs, seed=seed, device=device)
    # the warm-up: a throwaway processor through every graph and kernel a
    # push runs (its first push captures, the next ones replay)
    state.proc = _processor(state)
    for p in range(3):
        _push(state, p)
    # the measured processor; an FM stream's first push has no result yet
    state.proc = _processor(state)
    if not _wideband(g):
        _push(state, 0)
        state.first = 1
    return state


def window(state: State, seconds: float) -> dict:
    wideband = _wideband(state.g)
    mix = state.cell.mix
    salt = state.cell.check["sample_salt"]
    maps = Reservoir(**mix["kept_maps"], rng=np.random.default_rng(
        [state.seed % (1 << 63), salt]))
    steps = Reservoir(**mix["kept_steps"], rng=np.random.default_rng(
        [state.seed % (1 << 63), salt, 1]))
    before = None                  # the tables of the last result, copied
    p = state.first
    failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        result = _push(state, p)
        state.push_ms.append((time.perf_counter() - t) * 1e3)
        if result is None:
            failed += 1
            before = None
            p += 1
            continue
        res = _channels(result, wideband)
        after = {k: _copy(r.tracks) for k, r in res.items()}
        maps.offer(p, lambda: {k: (np.array(r.caf), np.array(r.cfar))
                               for k, r in res.items()})
        if p == state.first or before is not None:
            steps.offer(p, lambda: {
                k: (None if before is None else before[k],
                    np.array(r.cfar), after[k]) for k, r in res.items()})
        before = after
        p += 1
    state.maps, state.steps = maps.items, steps.items
    ms = np.asarray(state.push_ms)
    return dict(metrics=dict(push_ms_p50=float(np.percentile(ms, 50))),
                attempted=len(ms), failed=failed, units=len(ms),
                notes=[f"{len(ms)} pushes, p95 {np.percentile(ms, 95):.3f}"
                       f" ms, p99 {np.percentile(ms, 99):.3f} ms, max "
                       f"{ms.max():.3f} ms"])


def release(state: State) -> None:
    state.proc = None


def _raw(state: State, frames, prec: Precision) -> tuple:
    r = state.ring_ref.shape[0]
    slots = [q % r for q in frames]

    def take(ring):
        return torch.from_numpy(np.ascontiguousarray(ring[slots])).to(
            state.device).to(prec.complex)

    return take(state.ring_ref), take(state.ring_srv)


def reference_maps(state: State, p: int, prec: Precision = FP64) -> dict:
    """{channel: CAF maps} of push p's result, by the reference."""
    g = state.g
    if _wideband(g):
        maps = pipelines.wideband_maps(*_raw(state, [p], prec), g, prec)[0]
        return {k: maps[i] for i, k in enumerate(g["select"])}
    f = p - 1                              # the frame push p finishes
    frames = list(range(max(0, f - 1), p + 1))
    ref, srv = pipelines.fm_clean(*_raw(state, frames, prec), frames, g,
                                  prec)
    i = f - frames[0]
    left = (ref[i - 1], srv[i - 1]) if i > 0 else None
    right = (ref[i + 1], srv[i + 1])
    return {0: pipelines.fm_maps(ref[i:i + 1], srv[i:i + 1], g, left, right,
                                 prec)[0]}


def _peak_error(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _extent(g) -> tuple:
    return (g["max_doppler"], g["max_range"])


def _k_max(cell, g) -> int:
    cells = g["num_doppler_cells"] * (g["num_range_cells"] + 1)
    return max(int(cell.config["max_measurements"]), int(0.003 * cells))


def control(cell, seed: int, device, prec: Precision) -> State:
    """The state a run would hold, with the reference in precision ``prec``
    in the program's place: its CAF maps and CFAR frames at the first
    ``control_steps`` pushes and at ``control_pushes`` more drawn from the
    seed below ``control_span``, and at the first ``control_steps`` the
    steps of its tracker, run in that precision on its CFAR frames.
    ``check`` judges it as it judges a run."""
    g = geometry.derive(cell.config)
    state = State(cell, g, *make_inputs(cell, seed, device), seed=seed,
                  device=device, first=0 if _wideband(g) else 1)
    steps = range(state.first, state.first + cell.check["control_steps"])
    rng = np.random.default_rng([seed % (1 << 63), cell.check["sample_salt"]])
    pushes = sorted(set(steps) | {int(p) for p in rng.integers(
        state.first + 1, cell.check["control_span"],
        cell.check["control_pushes"])})
    fw, gw = cell.mix["cfar_kernel"]
    q = detect.ROUNDING[prec.name]
    table: dict = {}
    for p in pushes:
        state.maps[p] = {}
        for k, m in reference_maps(state, p, prec).items():
            m = m.cpu().numpy()
            cf = detect.cfar(np.abs(m), fw, gw).astype(np.float32)
            state.maps[p][k] = (m, cf)
            if p in steps:
                after = detect.step(
                    table.get(k) or detect.init_table(cell.mix["n_tracks"]),
                    cf, _extent(g), _k_max(cell, g), q)
                state.steps.setdefault(p, {})[k] = (table.get(k), cf, after)
                table[k] = after
    return state


def check(state: State) -> list:
    limits = state.cell.check["limits"]
    g = state.g
    fw, gw = state.cell.mix["cfar_kernel"]
    map_err = cfar_err = track_err = 0.0
    mismatches = 0
    for p in sorted(state.maps):
        want = reference_maps(state, p)
        for k, (caf, cf) in state.maps[p].items():
            w = want[k].cpu().numpy()
            map_err = max(map_err, _peak_error(caf, w))
            cfar_err = max(cfar_err, _peak_error(
                cf, detect.cfar(np.abs(w), fw, gw)))
    # the tracker, one step on the program's CFAR frame from the table the
    # program returned before it (a fresh one at the stream's first result)
    fresh = detect.init_table(state.cell.mix["n_tracks"])
    for p in sorted(state.steps):
        for k, (before, cf, after) in state.steps[p].items():
            table = detect.step(fresh if before is None else before, cf,
                                _extent(g), _k_max(state.cell, g))
            bad, err = detect.compare(after, table)
            mismatches += bad
            track_err = max(track_err, err)
    return [("map_err", map_err, limits["map_err"]),
            ("cfar_err", cfar_err, limits["cfar_err"]),
            ("track_mismatch", float(mismatches), limits["track_mismatch"]),
            ("track_err", track_err, limits["track_err"])]
