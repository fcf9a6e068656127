"""The LS clutter stage as a replayed CUDA graph.

``ls_filter_multiple_graphed`` takes the arguments of
``ops/clutter.ls_filter_multiple`` and returns what it returns. On a CUDA
tensor it runs the stage as a captured ``torch.cuda.CUDAGraph``: the eager
stage is a few hundred small launches a batch (the Levinson kernel among
them), so its time is the host's enqueue; a replay is one graph launch. The
JAX package compiles the same stage into one XLA program; the graph is the
port's counterpart, and ``ls_filter_multiple`` stays the eager library
function.

* The first call for a key runs the eager stage (the warm-up; its result
  is that call's answer), then captures it; each later call replays the
  graph and returns a fresh tensor (ops/graphs.py).
* The key holds everything that changes what the eager stage would launch:
  the device, the shapes, ``filter_len``, the sample rate, the bins, impl
  and solver, and the route (``route``): whether ``PASSIVERADAR_PALLAS_FFT``
  sends the full-length transforms to the fused kernel, and the functions
  that ``ops/fft.py`` and ``ops/clutter.py`` look up at call time for the
  fused FFT and the Levinson kernel. A graph captured under one route never
  replays under another.
* The graph is kept in the port's one graph cache (ops/graphs.py: an LRU
  a device under one memory budget, the launch counters kept true across
  capture and replays); ``cache_info`` lists it there.
* Every ``clutter_impl`` × ``clutter_solver`` is captured (the cuSOLVER
  and cuBLAS calls of ``cholesky`` and the dense solvers too). A capture
  that fails raises: no error is turned into an eager run.

CPU tensors run the eager stage.
"""

from __future__ import annotations

import torch

from passiveradar_torch.ops import fft_kernel, graphs, levinson_kernel
from passiveradar_torch.ops.clutter import ls_filter_multiple
from passiveradar_torch.ops.graphs import cache_info, counters  # noqa: F401

_graphs = graphs._graphs    # the cache the stage's graphs are kept in


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
    return graphs.call("clutter", key, (ref, srv), run, info=dict(
        shape=list(ref.shape), impl=impl, solver=solver,
        fused_fft=key[-1][0]))
