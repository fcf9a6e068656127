"""Traffic kind ``ring_capture``: back-to-back captures through the port's
batch host loop, read from a ring of frames in host memory.

The mix's parameters: ``ring_frames`` distinct frames in the ring,
``call_frames`` frames a capture, ``scene`` (core/scene.py), and
``keep_positions`` (the frame positions of each capture that are kept for
the check, besides ``seeded_positions`` more drawn from the seed).
Capture c reads its frame i from ring slot (c + i) mod ``ring_frames``.

An FM configuration runs ``pipeline.run_capture`` on int16 IQ pairs (the
SDR's recording format, ``int16_scale``); a wideband one
``wideband.run_wideband_capture`` on complex64 CPIs, with ``integrate``
from the mix. The reader and the writers are the benchmark's own: the
reader serves the ring, the writers keep the checked frames in memory and
count the rest (the integrated wideband stack is written by the program
to ``benchmark/.out/``).

End-to-end metric ``frames_per_s``: the frames of every capture begun in
the window over the time to the last capture's end (a wideband CPI, all
channels, is one frame). The check compares a sample of the kept frames,
drawn from the seed, with the reference (reference/pipelines.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib

import numpy as np
import torch

from benchmark.core import scene as scenes
from benchmark.reference import chain, geometry, pipelines
from benchmark.reference.precision import FP64, Precision

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".out")


class RingReader:
    """A capture of ``frames`` frames served from the ring as a live SDR's
    ring buffer serves them: views, no copy (the port's CaptureReader
    interface: ``read_pair_frames`` for int16 pairs, ``read_iq_frames`` for
    complex64). The ring arrays hold ``ring_frames`` frames and then their
    first ones again, so that every read of up to the extra frames is one
    contiguous view."""

    def __init__(self, ring_ref, ring_srv, ring_frames: int, offset: int,
                 frames: int):
        self.ref, self.srv = ring_ref, ring_srv
        self.ring_frames = ring_frames
        self.offset = offset
        self.num_frames = frames
        self.pair_dtype = ring_ref.dtype

    def _take(self, ring, start, count):
        a = (self.offset + start) % self.ring_frames
        if a + count > ring.shape[0]:
            raise ValueError(f"a read of {count} frames is longer than the "
                             "ring's wrap margin")
        return ring[a:a + count]

    def read_pair_frames(self, start: int, count: int):
        return (self._take(self.ref, start, count),
                self._take(self.srv, start, count))

    read_iq_frames = read_pair_frames


class Sink:
    """The port's MapWriter interface in memory: keeps the frames at
    ``keep`` positions (copies: the loop reuses its buffers), counts the
    frames written."""

    def __init__(self, keep):
        self.keep = set(keep)
        self.frames_done = 0
        self.written = 0
        self.kept: dict = {}

    def write(self, frames, start: int):
        frames = np.asarray(frames)
        for i in range(frames.shape[0]):
            if start + i in self.keep:
                self.kept[start + i] = np.array(frames[i])
        self.written += frames.shape[0]


@dataclasses.dataclass
class State:
    cell: object
    cfg: object
    g: dict
    ring_ref: np.ndarray
    ring_srv: np.ndarray
    keep: list
    seed: int
    device: torch.device
    captures: list = dataclasses.field(default_factory=list)
    # the integrated stack's kept frames of the last capture, by position
    integrated: dict = dataclasses.field(default_factory=dict)


def _wideband(g) -> bool:
    return bool(g["channels"])


def make_inputs(cell, seed: int, device):
    g = geometry.derive(cell.config)
    mix = cell.mix
    ref, srv = scenes.make_ring(g, mix["scene"], mix["ring_frames"], seed,
                                device)
    # the wrap margin: a batch's frames with its two halo frames
    margin = int(cell.config["frame_batch"]) + 2
    ref, srv = (torch.cat([x, x[:margin]]) for x in (ref, srv))
    if _wideband(g):
        return scenes.to_complex64(ref), scenes.to_complex64(srv)
    return (scenes.to_int16_pairs(ref, g["int16_scale"]),
            scenes.to_int16_pairs(srv, g["int16_scale"]))


def _config(cell):
    from passiveradar_torch import derive_config
    os.makedirs(OUT_DIR, exist_ok=True)
    return derive_config(dict(cell.config, output_fname=os.path.join(
        OUT_DIR, cell.name), num_frames=cell.mix["call_frames"]))


def _capture(state: State, index: int, frames: int) -> Sink:
    """One capture of ``frames`` frames starting at ring slot ``index``."""
    r = state.cell.mix["ring_frames"]
    reader = RingReader(state.ring_ref, state.ring_srv, r, index % r, frames)
    if _wideband(state.g):
        from passiveradar_torch.wideband import run_wideband_capture
        sinks = {k: Sink(state.keep) for k in state.cfg.wideband_channel_select}
        run_wideband_capture(reader, state.cfg, writers=sinks,
                             progress=False,
                             integrate=state.cell.mix.get("integrate", False),
                             device=state.device)
        sink = Sink(())
        sink.written = min(s.written for s in sinks.values())
        sink.kept = {p: np.stack([s.kept[p] for s in sinks.values()])
                     for p in state.keep
                     if all(p in s.kept for s in sinks.values())}
        return sink
    from passiveradar_torch.pipeline import run_capture
    sink = Sink(state.keep)
    run_capture(reader, sink, state.cfg, progress=False, device=state.device)
    return sink


def _keep(cell, seed: int) -> list:
    """The frame positions of each capture kept for the check: the mix's
    and ``seeded_positions`` more drawn from the seed."""
    n = cell.mix["call_frames"]
    rng = np.random.default_rng([seed % (1 << 63), cell.check["sample_salt"]])
    return sorted(set(p % n for p in cell.mix["keep_positions"]) |
                  set(int(p) for p in rng.choice(
                      n, cell.mix["seeded_positions"], replace=False)))


def setup(cell, inputs, device, seed: int) -> State:
    state = State(cell, _config(cell), geometry.derive(cell.config), *inputs,
                  keep=_keep(cell, seed), seed=seed, device=device)
    # the warm-up: two batches, every graph and buffer the window uses
    _capture(state, 0, 2 * state.cfg.frame_batch)
    return state


def window(state: State, seconds: float) -> dict:
    n = state.cell.mix["call_frames"]
    t0 = time.perf_counter()
    frames = written = 0
    took = []
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        sink = _capture(state, len(state.captures), n)
        took.append(time.perf_counter() - t)
        state.captures.append(sink.kept)
        frames += n
        written += sink.written
    dt = time.perf_counter() - t0
    batches = len(state.captures) * -(-n // state.cfg.frame_batch)
    return dict(metrics=dict(frames_per_s=frames / dt), attempted=frames,
                failed=frames - written, units=batches,
                notes=["capture seconds " + " ".join(f"{x:.3f}"
                                                     for x in took)])


def _integrates(state: State) -> bool:
    return _wideband(state.g) and state.cell.mix.get("integrate", False)


def release(state: State) -> None:
    state.cfg = None
    if _integrates(state):
        state.integrated = {p: read_integrated(state.cell, p)
                            for p in state.keep}


def sample(state: State, seed: int) -> list:
    """(capture, position) pairs to compare: each kept position of the
    first and the last capture and of one drawn from the seed."""
    count = len(state.captures)
    rng = np.random.default_rng([seed % (1 << 63),
                                 state.cell.check["sample_salt"], 1])
    caps = sorted({0, count - 1, int(rng.integers(count))})
    return [(c, p) for c in caps for p in state.keep]


def reference_frame(state: State, capture: int, pos: int,
                    prec: Precision = FP64) -> torch.Tensor:
    """The reference's maps of frame ``pos`` of capture ``capture``: FM
    (nf, R + 1), wideband (S, nf, R + 1)."""
    g, dev = state.g, state.device
    n = state.cell.mix["call_frames"]
    r = state.cell.mix["ring_frames"]
    lo, hi = (pos, pos + 1) if _wideband(g) else (max(0, pos - 1),
                                                  min(n, pos + 2))
    slots = [(capture + i) % r for i in range(lo, hi)]

    def raw(ring):
        x = torch.from_numpy(np.ascontiguousarray(ring[slots])).to(dev)
        if _wideband(g):
            return x.to(prec.complex)
        x = x.to(prec.real) * g["int16_scale"]
        return torch.complex(x[..., 0], x[..., 1])

    if _wideband(g):
        return pipelines.wideband_maps(raw(state.ring_ref),
                                       raw(state.ring_srv), g, prec)[0]
    ref, srv = pipelines.fm_clean(raw(state.ring_ref), raw(state.ring_srv),
                                  list(range(lo, hi)), g, prec)
    i = pos - lo
    left = (ref[i - 1], srv[i - 1]) if i > 0 else None
    right = (ref[i + 1], srv[i + 1]) if pos + 1 < hi else None
    return pipelines.fm_maps(ref[i:i + 1], srv[i:i + 1], g, left, right,
                             prec)[0]


def read_integrated(cell, pos: int) -> np.ndarray:
    """Frame ``pos`` of the integrated stack the program wrote last (a zarr
    v2 array of (nf, R + 1, frames) complex64 in (nf, R + 1, 1) chunks),
    read with the standard library and NumPy."""
    path = os.path.join(OUT_DIR, f"{cell.name}.integrated.zarr")
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    with open(os.path.join(path, f"0.0.{pos}"), "rb") as f:
        raw = f.read()
    codec = (meta.get("compressor") or {}).get("id")
    if codec == "zlib":
        raw = zlib.decompress(raw)
    elif codec == "gzip":
        raw = zlib.decompress(raw, 16 + zlib.MAX_WBITS)
    elif codec is not None:
        raise ValueError(f"integrated stack compressed with {codec}")
    return np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(
        meta["chunks"][:2])


def peak_error(got: np.ndarray, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    want = want.cpu().numpy()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def control(cell, seed: int, device, prec: Precision) -> State:
    """The state a run of ``control_captures`` captures would hold, with
    the reference in precision ``prec`` in the program's place: its frames
    at every (capture, position) the check samples, and its integrated
    frames of the last capture. ``check`` judges it as it judges a run."""
    state = State(cell, None, geometry.derive(cell.config),
                  *make_inputs(cell, seed, device), keep=_keep(cell, seed),
                  seed=seed, device=device)
    count = cell.check["control_captures"]
    state.captures = [{} for _ in range(count)]
    for c, p in sample(state, seed):
        got = reference_frame(state, c, p, prec)
        state.captures[c][p] = got.cpu().numpy()
        if _integrates(state) and c == count - 1:
            state.integrated[p] = chain.integrate(
                got[None])[0].cpu().numpy()
    return state


def check(state: State) -> list:
    limits = state.cell.check["limits"]
    integrate = _integrates(state)
    last = len(state.captures) - 1
    worst = integ = 0.0
    for c, p in sample(state, state.seed):
        want = reference_frame(state, c, p)
        worst = max(worst, peak_error(state.captures[c][p], want))
        if integrate and c == last:
            integ = max(integ, peak_error(state.integrated[p],
                                          chain.integrate(want[None])[0]))
    checks = [("map_err", worst, limits["map_err"])]
    if integrate:
        checks.append(("integ_err", integ, limits["integ_err"]))
    return checks
