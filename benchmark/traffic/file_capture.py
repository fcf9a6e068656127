"""Traffic kind ``file_capture``: back-to-back calls of the batch user's
whole sequence over a recorded two-channel HDF5 capture, as
``cli.process.main`` runs it (upstream main.py:44-110, 205-227).

The mix's parameters are ``ring_capture``'s (``ring_frames``,
``call_frames``, ``scene``, ``keep_positions``, ``seeded_positions``) and
``skew_samples`` [lo, hi]: the start-time skew between the two receivers,
|k| drawn from the seed, uniform in lo..hi complex samples, with either
channel leading.

Set-up writes the capture: ``call_frames`` + 1 aligned frames a channel
(the last is the last map's right halo), aligned frame j being ring slot
j mod ``ring_frames``, as separate contiguous int16 IQ datasets at the
configuration's ``input_ref_path`` and ``input_srv_path``. The lagging
channel starts k samples early (the ring's samples before frame 0), the
leading one ends k samples late, so that the offset search has k to find.
It is written in slices, through the HDF5 backend the port's reader opens
(``io/writers.hdf5_backend()``), into a fresh directory under
``tempfile.gettempdir()`` (the run's TMPDIR), after a check that it has
the room, which ``release`` removes, as does an ``atexit`` hook for a run
that fails. A second capture of 2 x ``frame_batch`` frames
warms up the same sequence and is removed after it.

A call: ``io/hdf5.CaptureReader`` (its offset search), the frame count,
``io/writers.MapWriter`` (the stack overwritten), ``pipeline.run_capture``,
both files closed, ``write_metadata``; then, still in the window, the
kept frames and ``frames_done`` read back from the written stack through
the same backend (tests/test_torch_file_cell.py holds io/hdf5_min's stack
against h5py).

End-to-end metric ``frames_per_s``: ``call_frames`` a call over the time
to the last call's end. The check compares the read-back frames of the
first, the last and one drawn call with the reference
(reference/pipelines.py; file frame j is ring slot j mod ``ring_frames``),
each call's offset with the planted k, and each call's ``frames_done``
with its frame count.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.core import scene as scenes
from benchmark.reference import geometry, pipelines
from benchmark.reference.precision import FP64, Precision
from benchmark.traffic import ring_capture as ring

sample, peak_error = ring.sample, ring.peak_error

SLICE = 1 << 24            # complex samples written a step (64 MiB of int16)


@dataclasses.dataclass
class Files:
    directory: str
    capture: str           # the window's capture
    warm: str              # the warm-up's capture
    where: str             # the note: size, backend, directory
    remove: object         # removes the directory; registered with atexit


@dataclasses.dataclass
class State:
    cell: object
    cfg: object
    g: dict
    ring_ref: np.ndarray   # (ring_frames, frame_len, 2) int16
    ring_srv: np.ndarray
    skew: int
    files: Files | None
    keep: list
    seed: int
    device: torch.device
    # a call each: the kept frames read back, by position; the offset the
    # reader found; the stack's frames_done
    captures: list = dataclasses.field(default_factory=list)
    offsets: list = dataclasses.field(default_factory=list)
    frames_done: list = dataclasses.field(default_factory=list)


def skew(cell, seed: int) -> int:
    """The planted skew k from the seed: the reader's offset, positive when
    the reference channel lags (starts early)."""
    lo, hi = cell.mix["skew_samples"]
    rng = np.random.default_rng([seed % (1 << 63), cell.check["sample_salt"],
                                 2])
    mag = int(rng.integers(lo, hi + 1))
    return mag if rng.integers(2) else -mag


def _ring(cell, seed: int, device) -> tuple:
    g = geometry.derive(cell.config)
    ref, srv = scenes.make_ring(g, cell.mix["scene"], cell.mix["ring_frames"],
                                seed, device)
    return (scenes.to_int16_pairs(ref, g["int16_scale"]),
            scenes.to_int16_pairs(srv, g["int16_scale"]))


def _stream(ring_arr: np.ndarray, a: int, b: int):
    """Complex samples [a, b) of the ring's tiled stream (sample t is ring
    sample t mod its length; t < 0 comes before frame 0) as flat int16 IQ
    views of at most SLICE samples."""
    flat = ring_arr.reshape(-1, 2)
    t = a
    while t < b:
        i = t % flat.shape[0]
        m = min(b - t, flat.shape[0] - i, SLICE)
        yield flat[i:i + m].reshape(-1)
        t += m


def write_capture(path: str, params: dict, ring_ref: np.ndarray,
                  ring_srv: np.ndarray, frames: int, k: int,
                  backend=None) -> None:
    """A two-channel int16 capture of ``frames`` aligned frames of the
    rings with the skew ``k``, written slice by slice through ``backend``
    (default: the port's ``io/writers.hdf5_backend()``)."""
    if backend is None:
        from passiveradar_torch.io.writers import hdf5_backend
        backend = hdf5_backend()
    n = frames * ring_ref.shape[1]
    lag, lead = max(k, 0), max(-k, 0)
    channels = {params["input_ref_path"]: (ring_ref, -lag, n + lead),
                params["input_srv_path"]: (ring_srv, -lead, n + lag)}
    with backend.File(path, "w") as f:
        for key, (arr, a, b) in channels.items():
            d = f.create_dataset(key, shape=(2 * (b - a),), dtype=np.int16)
            at = 0
            for piece in _stream(arr, a, b):
                d[at:at + piece.size] = piece
                at += piece.size


def _free(path: str) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def _directory(need: int) -> str:
    """A fresh directory under tempfile.gettempdir() with room for ``need``
    bytes."""
    base = tempfile.gettempdir()
    if _free(base) < need:
        raise OSError(
            f"the file cell needs {need / 1e9:.2f} GB for its capture and "
            f"map stack: {base} has {_free(base) / 1e9:.2f} GB free; point "
            "TMPDIR at a larger file system")
    return tempfile.mkdtemp(prefix="fm_file_", dir=base)


def _write_files(cell, ring_ref, ring_srv, k: int) -> Files:
    from passiveradar_torch.io.writers import hdf5_backend
    p, mix = cell.config, cell.mix
    g = geometry.derive(p)
    frames, warm = mix["call_frames"] + 1, 2 * int(p["frame_batch"])
    stack = g["num_doppler_cells"] * (g["num_range_cells"] + 1) * 8
    need = (8 * ((frames + warm) * g["frame_len"] + 2 * abs(k))
            + stack * (mix["call_frames"] + warm) + (1 << 20))
    d = _directory(need)
    remove = functools.partial(shutil.rmtree, d, ignore_errors=True)
    atexit.register(remove)
    files = Files(d, os.path.join(d, "capture.h5"),
                  os.path.join(d, "warm.h5"), "", remove)
    try:
        backend = hdf5_backend()
        write_capture(files.capture, p, ring_ref, ring_srv, frames, k,
                      backend)
        write_capture(files.warm, p, ring_ref, ring_srv, warm, k, backend)
    except BaseException:
        remove()
        raise
    files.where = (f"capture {os.path.getsize(files.capture) / 1e9:.3f} GB "
                   f"written with {backend.__name__.split('.')[-1]} in {d} "
                   f"({need / 1e9:.2f} GB asked)")
    return files


def make_inputs(cell, seed: int, device):
    ring_ref, ring_srv = _ring(cell, seed, device)
    k = skew(cell, seed)
    return ring_ref, ring_srv, k, _write_files(cell, ring_ref, ring_srv, k)


def _call(state: State, path: str | None = None,
          stack: str | None = None) -> tuple:
    """cli.process.main's sequence over the capture at ``path`` (default:
    the configuration's), its stack at ``stack`` (default: the
    configuration's). Returns (the offset found, the frames written)."""
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.io.writers import MapWriter, write_metadata
    from passiveradar_torch.pipeline import capture_frame_count, run_capture
    cfg = state.cfg
    reader = CaptureReader(cfg, path, device=state.device)
    try:
        writer = MapWriter(cfg, capture_frame_count(reader, cfg), stack)
        try:
            n = run_capture(reader, writer, cfg, progress=False,
                            device=state.device)
        finally:
            writer.close()
    finally:
        reader.close()
    write_metadata(cfg, n)
    return reader.offset, n


@contextlib.contextmanager
def _removed_on_failure(state: State):
    """The run's files removed at once where the work inside fails."""
    try:
        yield
    except BaseException:
        release(state)
        raise


def _backend_name() -> str:
    from passiveradar_torch.io.writers import hdf5_backend
    return hdf5_backend().__name__.split(".")[-1]


def _read_back(state: State) -> tuple:
    """(kept frames by position, frames_done) of the written stack."""
    from passiveradar_torch.io.writers import hdf5_backend
    with hdf5_backend().File(state.cfg.range_doppler_map_fname, "r") as f:
        d = f["/xambg"]
        kept = {p: np.asarray(d[:, :, p]) for p in state.keep}
        return kept, int(d.attrs.get("frames_done", 0))


def setup(cell, inputs, device, seed: int) -> State:
    from passiveradar_torch import derive_config
    ring_ref, ring_srv, k, files = inputs
    cfg = derive_config(dict(
        cell.config, input_file=files.capture,
        output_fname=os.path.join(files.directory, "XAMBG"),
        range_doppler_map_ftype="hdf5", num_frames=cell.mix["call_frames"]))
    state = State(cell, cfg, geometry.derive(cell.config), ring_ref,
                  ring_srv, k, files, keep=ring._keep(cell, seed), seed=seed,
                  device=device)
    # the warm-up: the same sequence over 2 x frame_batch frames, every
    # graph, plan and buffer the window uses
    stack = os.path.join(files.directory, "warm.hdf5")
    with _removed_on_failure(state):
        _call(state, files.warm, stack)
    for path in (files.warm, stack):
        os.remove(path)
    return state


def _read_info():
    """The port's prefetch counters, or None where it keeps none."""
    from passiveradar_torch.io import hdf5
    info = getattr(hdf5, "read_info", None)
    return None if info is None else info()


def _read_note(before, after, seconds: float) -> str:
    if before is None or after is None:
        return ("prefetch reads: the port keeps no io/hdf5.read_info, so "
                "the prefetch thread is not seen")
    d = {k: after[k] - before[k] for k in after}
    b = max(d["batches"], 1)
    return (f"prefetch reads: {d['batches']} batches, "
            f"{d['bytes'] / 1e9:.3f} GB in {d['read_s']:.3f} s reading "
            f"({d['bytes'] / 1e9 / max(d['read_s'], 1e-9):.3f} GB/s; "
            f"{d['bytes'] / 1e9 / seconds:.3f} GB/s over the window), "
            f"{1e3 * d['read_s'] / b:.3f} ms a batch reading, "
            f"{1e3 * d['put_wait_s'] / b:.3f} ms a batch blocked on a full "
            "queue")


def window(state: State, seconds: float) -> dict:
    before = _read_info()
    t0 = time.perf_counter()
    frames = 0
    took = []
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        with _removed_on_failure(state):
            offset, n = _call(state)
            kept, done = _read_back(state)
        took.append(time.perf_counter() - t)
        state.captures.append(kept)
        state.offsets.append(offset)
        state.frames_done.append(done)
        frames += n
    dt = time.perf_counter() - t0
    written = sum(min(d, state.cfg.num_frames) for d in state.frames_done)
    bf = state.cfg.frame_batch
    return dict(
        metrics=dict(frames_per_s=frames / dt), attempted=frames,
        failed=frames - written,
        units=len(took) * -(-state.cfg.num_frames // bf),
        notes=["call seconds " + " ".join(f"{x:.3f}" for x in took),
               state.files.where,
               f"offsets found {sorted(set(state.offsets))} (planted "
               f"{state.skew}); frames_done {sorted(set(state.frames_done))}"
               f"; stack read back with {_backend_name()}, the backend "
               "that wrote it",
               _read_note(before, _read_info(), dt)])


def release(state: State) -> None:
    """The run's files removed (the directory and all in it)."""
    if state.files is not None:
        state.files.remove()
        atexit.unregister(state.files.remove)


def reference_frame(state: State, capture: int, pos: int,
                    prec: Precision = FP64) -> torch.Tensor:
    """The reference's maps (nf, R + 1) of frame ``pos`` of a call (every
    call reads the same file): file frames pos - 1 .. pos + 1, the last
    file frame being the last map's right halo."""
    g, dev = state.g, state.device
    r = state.cell.mix["ring_frames"]
    lo, hi = max(0, pos - 1), min(state.cell.mix["call_frames"] + 1, pos + 2)
    slots = [i % r for i in range(lo, hi)]

    def raw(ring_arr):
        x = torch.from_numpy(np.ascontiguousarray(ring_arr[slots])).to(dev)
        x = x.to(prec.real) * g["int16_scale"]
        return torch.complex(x[..., 0], x[..., 1])

    ref, srv = pipelines.fm_clean(raw(state.ring_ref), raw(state.ring_srv),
                                  list(range(lo, hi)), g, prec)
    i = pos - lo
    left = (ref[i - 1], srv[i - 1]) if i > 0 else None
    right = (ref[i + 1], srv[i + 1]) if pos + 1 < hi else None
    return pipelines.fm_maps(ref[i:i + 1], srv[i:i + 1], g, left, right,
                             prec)[0]


def _wanted(state: State, prec: Precision = FP64) -> dict:
    """The reference's maps at every position the check samples, each
    computed once (every call reads the same file)."""
    return {p: reference_frame(state, 0, p, prec)
            for p in sorted({p for _, p in sample(state, state.seed)})}


def control(cell, seed: int, device, prec: Precision) -> State:
    """The state a run of ``control_captures`` calls would hold, with the
    reference in precision ``prec`` in the program's place: its frames at
    every (call, position) the check samples, the planted offset found and
    every frame written."""
    state = State(cell, None, geometry.derive(cell.config),
                  *_ring(cell, seed, device), skew(cell, seed), None,
                  keep=ring._keep(cell, seed), seed=seed, device=device)
    count = cell.check["control_captures"]
    state.captures = [{} for _ in range(count)]
    want = _wanted(state, prec)
    for c, p in sample(state, seed):
        state.captures[c][p] = want[p].cpu().numpy()
    state.offsets = [state.skew] * count
    state.frames_done = [cell.mix["call_frames"]] * count
    return state


def check(state: State) -> list:
    limits = state.cell.check["limits"]
    want = _wanted(state)
    worst = max(peak_error(state.captures[c][p], want[p])
                for c, p in sample(state, state.seed))
    n = state.cell.mix["call_frames"]
    return [("map_err", worst, limits["map_err"]),
            ("offset_err", float(max(abs(o - state.skew)
                                     for o in state.offsets)),
             limits["offset_err"]),
            ("frames_missing", float(max(n - d for d in state.frames_done)),
             limits["frames_missing"])]
