"""Replayed CUDA graphs: one cache for every graph the port keeps.

The JAX package compiles each stage entry point, and the whole batch, into
one XLA program. The port's counterpart is a ``torch.cuda.CUDAGraph``
captured once per key and replayed: the eager chain is a few hundred small
launches a batch, so its time is the host's enqueue, and a replay is one
graph launch. ``graphed(kind, run, inputs, params)`` runs ``run(*inputs)``
(a pure function of a tuple of tensors that returns a tensor or a tuple of
them) that way for every user: ``pipeline.py``, ``streaming.py`` and
``ops/clutter.py``'s LS stage.

* CPU tensors run ``run`` eagerly, and so does a ``graphed`` call inside a
  graph being built: the outer graph holds its launches (a capture cannot
  start inside another).
* The first call for a key runs ``run`` eagerly on a side stream (the
  warm-up: libraries loaded, cuFFT plans and constant tables made; its
  result is that call's answer), then captures ``run`` on static copies of
  the inputs. Each later call copies its inputs into those buffers, replays
  the graph and returns clones of the static outputs (the next replay
  overwrites them). A caller may instead feed the static inputs from
  pinned host buffers and read the static outputs in stream order
  (``graphed(..., device=, fresh=False)``, as ``pipeline.run_capture``
  does).
* The key (``graph_key``) holds everything that changes what ``run`` would
  launch: the card, the shapes and dtypes, the parameters and the route
  (the kernel entry functions looked up at call time). A graph captured
  under one route never replays under another.
* Graphs are kept in an LRU a device, each with its own private memory
  pool. The kept pools share one budget a device (``BUDGET_SHARE`` of the
  card's memory), whatever kind of graph holds them; when
  a new graph takes it over the budget, the least recently used graphs are
  dropped, after the device has finished its work. ``cache_info`` lists
  them.
* A replay does not call the kernel wrappers, so at capture the counts
  of each counted kernel (``counters``: its ``launches``, and its other
  ``COUNTS`` where it keeps them) are taken off again and recorded with
  the wrapper that keeps them, and each replay adds them: a counter counts
  the launches that ran, and what they did.
* A key's warm-up and capture is a ``graph.capture/<kind>`` span
  (``spans.py``): one inside a measured window means a graph was built
  again (an eviction, or a key that changes every call).
* A capture that fails raises: no error is turned into an eager run.

Tables that a graph reads by address (the mixer's and the FFT's tables,
the LS stage's, the CAF window) are kept in unbounded caches by their
modules, so they outlive every graph.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field

import torch

from passiveradar_torch.spans import span

BUDGET_SHARE = 0.4       # of a card's memory, for the kept graphs' pools
# a kernel wrapper's counters that a replay adds to (``launches`` always)
COUNTS = ("launches", "frames")


@dataclass
class Graph:
    graph: object               # torch.cuda.CUDAGraph
    inputs: tuple               # static input buffers
    outputs: tuple              # static outputs, overwritten by each replay
    single: bool                # run returned one tensor, not a tuple
    launches: dict              # counted kernel launches a replay
    counted: tuple              # (wrapper, counter, count a replay)
    pool_bytes: int
    warmup_s: float
    capture_s: float
    kind: str = ""
    info: dict = field(default_factory=dict)
    replays: int = 0


_graphs: dict = {}          # device index → OrderedDict(key → Graph)
_building = 0               # > 0 while capture() warms up or records a graph


def kernels() -> dict:
    """The port's kernel wrappers (B1, B2, B3, T1, L1) as the code looks
    them up at call time, a stand-in included."""
    from passiveradar_torch.detect import tracker_kernel
    from passiveradar_torch.ops import (fft_kernel, levinson_kernel,
                                        nlms_kernel, resample_kernel)
    return dict(
        mix_regroup_matmul=resample_kernel.mix_regroup_matmul,
        nlms_filter_pallas=nlms_kernel.nlms_filter_batch,
        fft_fused=fft_kernel.fft_fused,
        multitarget_step=tracker_kernel.multitarget_step_kernel,
        levinson_first_col=levinson_kernel.levinson_first_col_kernel)


def counters() -> dict:
    """The kernel wrappers whose ``COUNTS`` a replay adds to; a stand-in
    counts nothing and is left out."""
    return {name: f for name, f in kernels().items()
            if hasattr(f, "launches")}


def route() -> tuple:
    """What a graphed ``run`` resolves at call time: the fused-FFT opt-in
    and ``kernels``. A stand-in swapped in gets graphs of its own."""
    from passiveradar_torch.ops import fft_kernel
    return (fft_kernel.use_fused(), *kernels().values())


def graph_key(kind: str, inputs, params, device=None) -> tuple:
    """The cache key of a ``graphed`` call: its kind, the card (default:
    the inputs'), ``params`` (what else ``run`` depends on), each input's
    shape and dtype, and the route."""
    dev = card(inputs[0].device if device is None else device)
    return (kind, dev, params,
            tuple((tuple(x.shape), x.dtype) for x in inputs), route())


def budget(dev: torch.device) -> int:
    """The bytes that the kept graphs' pools on ``dev`` may hold."""
    return int(BUDGET_SHARE * torch.cuda.get_device_properties(dev)
               .total_memory)


def cache_info() -> list:
    """The kept graphs, least recently used first: device, kind, key (the
    user's description of it), launches a replay, pool bytes, warm-up and
    capture seconds, replays."""
    return [dict(device=str(g.inputs[0].device), kind=g.kind, key=g.info,
                 launches=g.launches, pool_bytes=g.pool_bytes,
                 warmup_s=g.warmup_s, capture_s=g.capture_s,
                 replays=g.replays)
            for cache in _graphs.values() for g in cache.values()]


def card(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _reserved(dev: torch.device) -> int:
    return torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0


def _tensors(out) -> tuple:
    return (out,) if torch.is_tensor(out) else tuple(out)


def _warm_up(inputs: tuple, run):
    """run(*inputs) on a side stream, the caller's stream waiting for it."""
    dev = inputs[0].device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = run(*inputs)
    main.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(main)
    return out


def _record(inputs: tuple, run) -> tuple:
    """Capture run(*inputs) into a new graph: (graph, its outputs)."""
    dev = inputs[0].device
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(dev)
    cap = torch.cuda.Stream(dev)
    cap.wait_stream(main)
    with torch.cuda.stream(cap):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = run(*inputs)
        finally:
            graph.capture_end()
    main.wait_stream(cap)
    return graph, out


def _capture(inputs: tuple, run) -> tuple:
    """Warm up (the call's result), then capture ``run`` on static copies
    of the inputs. Returns (result, Graph)."""
    dev = inputs[0].device
    t0 = time.perf_counter()
    out = _warm_up(inputs, run)
    warmup_s = time.perf_counter() - t0
    static = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                   .copy_(x) for x in inputs)
    if dev.type == "cuda":
        # the allocator releases no cached block while a capture is under
        # way, so memory that the warm-up (on its own stream) and the
        # dropped graphs left cached is given back first
        torch.cuda.empty_cache()
    kernels = counters()
    before = {(name, attr): getattr(c, attr)
              for name, c in kernels.items() for attr in COUNTS
              if hasattr(c, attr)}
    reserved = _reserved(dev)
    t0 = time.perf_counter()
    try:
        graph, static_out = _record(static, run)
    finally:
        # the captured launches did not run: take their counts off again
        taken = {}
        for (name, attr), n in before.items():
            c = kernels[name]
            if getattr(c, attr) != n:
                taken[name, attr] = getattr(c, attr) - n
            setattr(c, attr, n)
    entry = Graph(graph, static, _tensors(static_out),
                  torch.is_tensor(static_out),
                  {name: n for (name, attr), n in taken.items()
                   if attr == "launches"},
                  tuple((kernels[name], attr, n)
                        for (name, attr), n in taken.items()),
                  _reserved(dev) - reserved, warmup_s,
                  time.perf_counter() - t0)
    return out, entry


def lookup(key, dev: torch.device):
    """The graph kept under ``key`` on ``dev`` (now the most recently
    used), or None."""
    cache = _graphs.get(dev.index)
    entry = None if cache is None else cache.get(key)
    if entry is not None:
        cache.move_to_end(key)
    return entry


def capture(kind: str, key, inputs: tuple, run, info=None):
    """A key's first call: run(*inputs) eagerly (its result is returned),
    then the graph of ``run`` kept under ``key``; graphs over the budget
    are dropped, least recently used first."""
    global _building
    dev = inputs[0].device
    _building += 1
    try:
        with span(f"graph.capture/{kind}"), _device(dev):
            out, entry = _capture(inputs, run)
    finally:
        _building -= 1
    entry.kind, entry.info = kind, dict(info or {})
    cache = _graphs.setdefault(dev.index, collections.OrderedDict())
    cache[key] = entry
    limit = budget(dev)
    while len(cache) > 1 and sum(g.pool_bytes
                                 for g in cache.values()) > limit:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        cache.popitem(last=False)
    return out


def replay(entry: Graph) -> tuple:
    """Replay ``entry`` on its static inputs (on their device's current
    stream) and count its launches. Returns its static outputs."""
    with _device(entry.inputs[0].device):
        entry.graph.replay()
    for wrapper, attr, n in entry.counted:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
    entry.replays += 1
    return entry.outputs


def call(kind: str, key, inputs: tuple, run, info=None, device=None,
         fresh: bool = True):
    """run(*inputs) (see the module docstring): the eager run on a key's
    first call, a replay after it. With ``device`` the inputs may lie on
    the host (pinned, so that the copies into the static inputs do not
    wait). Returns fresh tensors, as ``run`` returns them; with ``fresh``
    False a replay returns the static outputs themselves, which the next
    replay of the key overwrites (read them in stream order before it)."""
    dev = inputs[0].device if device is None else card(device)
    entry = lookup(key, dev)
    if entry is None:
        with _device(dev):
            inputs = tuple(x.to(dev, non_blocking=True) for x in inputs)
        return capture(kind, key, inputs, run, info)
    with _device(dev):
        for dst, src in zip(entry.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        outs = replay(entry)
        if fresh:
            outs = tuple(t.clone() for t in outs)
    return outs[0] if entry.single else outs


def graphed(kind: str, run, inputs: tuple, params, device=None,
            fresh: bool = True, info=None):
    """run(*inputs) (see the module docstring): replayed on a card, one
    graph a ``graph_key``. ``device``, ``fresh`` as for ``call``; ``info``
    adds to the graph's description in ``cache_info``."""
    dev = card(inputs[0].device if device is None else device)
    if dev.type != "cuda" or _building:
        return run(*inputs)
    key = graph_key(kind, inputs, params, dev)
    return call(kind, key, inputs, run, device=dev, fresh=fresh, info=dict(
        shapes=[list(x.shape) for x in inputs],
        dtypes=[str(x.dtype) for x in inputs], fused_fft=key[-1][0],
        **(info or {})))
