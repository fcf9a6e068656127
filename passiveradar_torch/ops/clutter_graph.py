"""The LS clutter stage as a replayed CUDA graph.

``ls_filter_multiple_graphed`` takes the arguments of
``ops/clutter.ls_filter_multiple`` and returns what it returns. On a CUDA
tensor it runs the stage as a captured ``torch.cuda.CUDAGraph``: the eager
stage is a few hundred small launches a batch (the Levinson kernel among
them), so its time is the host's enqueue; a replay is one graph launch. The
JAX package compiles the same stage into one XLA program; the graph is the
port's counterpart, and ``ls_filter_multiple`` stays the eager library
function.

* The first call for a key runs the eager stage on a side stream (the
  warm-up: libraries loaded, cuFFT plans and the constant tables made; its
  result is that call's answer), then captures the stage on the caller's
  inputs copied into static buffers. Each later call copies its inputs into
  those buffers, replays the graph and returns a clone of the static output
  (the next replay overwrites it).
* The key holds everything that changes what the eager stage would launch:
  the device, the shapes, ``filter_len``, the sample rate, the bins, impl
  and solver, and the route (``route``): whether ``PASSIVERADAR_PALLAS_FFT``
  sends the full-length transforms to the fused kernel, and the functions
  that ``ops/fft.py`` and ``ops/clutter.py`` look up at call time for the
  fused FFT and the Levinson kernel. A graph captured under one route never
  replays under another.
* Graphs are kept in an LRU of ``MAX_GRAPHS`` a device, each with its own
  private memory pool (``cache_info`` gives the bytes each reserved at
  capture); the least recently used is dropped, after its device has
  finished its work, when a new key needs room.
* A replay does not call the kernel wrappers, so at capture the launches of
  each counted kernel (``counters``) are taken off again and recorded, and
  each replay adds them: a counter counts the launches that ran.
* Every ``clutter_impl`` × ``clutter_solver`` is captured (the cuSOLVER
  and cuBLAS calls of ``cholesky`` and the dense solvers too). A capture
  that fails raises: no error is turned into an eager run.

CPU tensors run the eager stage.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass

import torch

from passiveradar_torch.ops import fft_kernel, levinson_kernel
from passiveradar_torch.ops.clutter import ls_filter_multiple

MAX_GRAPHS = 4


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    ref: torch.Tensor
    srv: torch.Tensor
    out: torch.Tensor
    launches: dict
    pool_bytes: int
    warmup_s: float
    capture_s: float
    replays: int = 0


_graphs: dict = {}          # device index → OrderedDict(key → _Graph)


def counters() -> dict:
    """The port's kernel wrappers, whose ``launches`` a replay adds to; a
    stand-in put in a wrapper's place (a reference route) counts nothing
    and is left out."""
    from passiveradar_torch.detect import tracker_kernel
    from passiveradar_torch.ops import nlms_kernel, resample_kernel
    wrappers = dict(
        mix_regroup_matmul=resample_kernel.mix_regroup_matmul,
        nlms_filter_pallas=nlms_kernel.nlms_filter_batch,
        fft_fused=fft_kernel.fft_fused,
        multitarget_step=tracker_kernel.multitarget_step_kernel,
        levinson_first_col=levinson_kernel.levinson_first_col_kernel)
    return {name: f for name, f in wrappers.items()
            if hasattr(f, "launches")}


def route() -> tuple:
    """What the stage resolves at call time: the fused-FFT opt-in and the
    fused FFT's and the Levinson kernel's entry functions."""
    return (fft_kernel.use_fused(), fft_kernel.fft_fused,
            levinson_kernel.levinson_first_col_kernel)


def graph_key(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
              sample_rate: float, doppler_bins=(0,),
              solver: str = "levinson", impl: str = "carry") -> tuple:
    """The cache key of a call: every argument that changes the launches,
    and the route."""
    return (ref.device, tuple(ref.shape), tuple(srv.shape), int(filter_len),
            float(sample_rate), tuple(float(b) for b in doppler_bins),
            impl, solver, route())


def cache_info() -> list:
    """The kept graphs, least recently used first: device, shapes, impl,
    solver, launches a replay, pool bytes, warm-up and capture seconds,
    replays."""
    return [dict(device=str(k[0]), shape=list(k[1]), impl=k[6],
                 solver=k[7], fused_fft=k[8][0], launches=g.launches,
                 pool_bytes=g.pool_bytes, warmup_s=g.warmup_s,
                 capture_s=g.capture_s, replays=g.replays)
            for cache in _graphs.values() for k, g in cache.items()]


def _capture(ref, srv, run) -> tuple:
    """Warm up on a side stream (the call's result), then capture ``run``
    on static copies of the inputs. Returns (result, _Graph)."""
    dev = ref.device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        out = run(ref, srv)
    main.wait_stream(side)
    out.record_stream(main)
    warmup_s = time.perf_counter() - t0

    static_ref = torch.empty_like(ref, memory_format=torch.contiguous_format)
    static_srv = torch.empty_like(srv, memory_format=torch.contiguous_format)
    static_ref.copy_(ref)
    static_srv.copy_(srv)
    graph = torch.cuda.CUDAGraph()
    cap = torch.cuda.Stream(dev)
    cap.wait_stream(main)
    kernels = counters()
    before = {name: c.launches for name, c in kernels.items()}
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(cap):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = run(static_ref, static_srv)
            finally:
                graph.capture_end()
    finally:
        # the captured launches did not run: take them off again
        launches = {name: c.launches - before[name]
                    for name, c in kernels.items()
                    if c.launches != before[name]}
        for name, c in kernels.items():
            c.launches = before[name]
    main.wait_stream(cap)
    entry = _Graph(graph, static_ref, static_srv, static_out, launches,
                   torch.cuda.memory_reserved(dev) - reserved, warmup_s,
                   time.perf_counter() - t0)
    return out, entry


def ls_filter_multiple_graphed(ref: torch.Tensor, srv: torch.Tensor,
                               filter_len: int, sample_rate: float,
                               doppler_bins=(0,), solver: str = "levinson",
                               impl: str = "carry") -> torch.Tensor:
    """``ls_filter_multiple(ref, srv, filter_len, sample_rate,
    doppler_bins, solver=solver, impl=impl)`` (see the module docstring):
    a replayed CUDA graph on CUDA tensors, the eager stage on CPU tensors.
    Returns a fresh tensor."""
    def run(r, s):
        return ls_filter_multiple(r, s, filter_len, sample_rate,
                                  doppler_bins, solver=solver, impl=impl)

    if ref.device.type != "cuda":
        return run(ref, srv)
    ref = ref.to(torch.complex64)
    srv = srv.to(device=ref.device, dtype=torch.complex64)
    key = graph_key(ref, srv, filter_len, sample_rate, doppler_bins, solver,
                    impl)
    cache = _graphs.setdefault(ref.device.index, collections.OrderedDict())
    with torch.cuda.device(ref.device):
        entry = cache.get(key)
        if entry is None:
            out, entry = _capture(ref, srv, run)
            cache[key] = entry
            if len(cache) > MAX_GRAPHS:
                torch.cuda.synchronize(ref.device)
                cache.popitem(last=False)
            return out
        cache.move_to_end(key)
        entry.ref.copy_(ref)
        entry.srv.copy_(srv)
        entry.graph.replay()
        kernels = counters()
        for name, n in entry.launches.items():
            kernels[name].launches += n
        entry.replays += 1
        return entry.out.clone()
