"""The port's graph cache (ops/graphs.py) and its graphed entry points, on
the CPU.

* The graphs' key (graphs.graph_key) tells apart every config field,
  input dtype and shape, and, for the batch's and the LS stage's graphs,
  every route and parameter that changes the launches.
* The cache with the CUDA capture replaced by a stand-in: its LRU under one
  memory budget a device, the kernel launch counters at capture and at
  replay, static inputs and fresh outputs, and the entry points' graph
  functions, whose graphed LS stage runs eagerly while their graph is
  built (no nested capture).
* Every graphed entry point on CPU tensors (where it runs the eager chain)
  bit-equal to the eager function, and against the JAX package at the
  port's pipeline bound (1e-4 of the peak, argmax equal:
  tests/test_torch_pipeline.py; the golden chain bound of
  tests/test_golden_e2e.py:93-100 is 2e-3).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu import pipeline as jp  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch import streaming as ts  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.detect import tracker_kernel as tk  # noqa: E402
from passiveradar_torch.detect import trackers  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_arrays)
from passiveradar_torch.ops import clutter as tc  # noqa: E402
from passiveradar_torch.ops import fft_kernel as fk  # noqa: E402
from passiveradar_torch.ops import graphs  # noqa: E402
from passiveradar_torch.ops import levinson_kernel as lk  # noqa: E402
from passiveradar_torch.ops import nlms_kernel as nk  # noqa: E402
from passiveradar_torch.ops import resample_kernel as rk  # noqa: E402
from passiveradar_torch.parallel.mesh import make_mesh  # noqa: E402
from tests.test_torch_pipeline import TINY, _assert_maps_agree  # noqa: E402

METHODS = ("ls_multiple", "nlms", "nlms_pallas", "none")


def _frames(cfg, n_frames, seed=3, pairs=False):
    ref, srv = synth_capture_arrays(cfg, n_frames,
                                    targets=(Target(40, 20.0, 0.1),),
                                    seed=seed)
    n = cfg.input_chunk_length
    shape = (n_frames, n // 2, 2) if pairs else (n_frames, n)
    return (torch.from_numpy(ref[:n_frames * n].reshape(shape)),
            torch.from_numpy(srv[:n_frames * n].reshape(shape)),
            torch.from_numpy(tp.frame_phases(cfg, list(range(n_frames)))))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bits (NaN frames compare equal to themselves)."""
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.contiguous().view(torch.int32)


# ---- the key ----------------------------------------------------------------

def _other(value):
    """A value of the same kind that differs from ``value``."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, str):
        return value + "_"
    if isinstance(value, tuple):
        return value + (7,)
    raise TypeError(type(value))


def test_batch_graph_key_tells_every_config_field_apart():
    """Each field of the config, changed alone, gives another key; an
    equal call gives an equal, hashable key."""
    cfg = t_derive(TINY)
    ref, srv, ph = _frames(cfg, 2)
    inputs = (ref, srv, ph)
    base = graphs.graph_key("frames", inputs, cfg)
    assert graphs.graph_key("frames", inputs, cfg, "cpu") == base
    hash(base)
    keys = [base]
    for f in dataclasses.fields(cfg):
        other = dataclasses.replace(cfg, **{f.name: _other(getattr(cfg,
                                                                    f.name))})
        keys.append(graphs.graph_key("frames", inputs, other))
    assert len(set(keys)) == len(keys)


def test_batch_graph_key_tells_inputs_and_kinds_apart():
    """The key changes with each input's dtype (int16 and float32 IQ pairs,
    complex64) and shape, with the kind and with what else the function
    takes (``params`` beyond the config)."""
    cfg = t_derive(TINY)
    ref, srv, ph = _frames(cfg, 2, pairs=True)
    base = (ref, srv, ph)
    variants = [
        base,
        (ref.to(torch.int16), srv.to(torch.int16), ph),
        (torch.view_as_complex(ref), torch.view_as_complex(srv), ph),
        (ref[:1], srv[:1], ph[:1]),
        (ref, srv, ph.double()),
    ]
    keys = [graphs.graph_key("frames", v, cfg) for v in variants]
    keys += [graphs.graph_key("groups", base, cfg),
             graphs.graph_key("frames", base, (cfg, (18, 4))),
             graphs.graph_key("frames", base, (cfg, (18, 5)))]
    assert len(set(keys)) == len(keys)


def _ls_params(ref, srv, filter_len=12, bins=(0, 1, -1, 2, -2),
               impl="carry", solver="levinson"):
    """The params that ops/clutter.ls_filter_multiple_graphed keys its
    graph by (graphs.graphed replaced by one that returns them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "graphed", lambda kind, run, inputs, params,
                   **kw: params)
        return tc.ls_filter_multiple_graphed(ref, srv, filter_len, 2048.0,
                                             bins, solver=solver, impl=impl)


def _route_cases(kind):
    """(inputs, params, [(inputs, params) of calls that must key apart])
    of a ``frames`` or a ``clutter`` graph."""
    if kind == "frames":
        cfg = t_derive(TINY)
        inputs = _frames(cfg, 2)
        return inputs, cfg, [(tuple(x[:1] for x in inputs), cfg)]
    rng = np.random.default_rng(19)
    ref, srv = (torch.from_numpy((rng.standard_normal((2, 2048))
                                  + 1j * rng.standard_normal((2, 2048)))
                                 .astype(np.complex64)) for _ in range(2))
    return (ref, srv), _ls_params(ref, srv), [
        ((ref[:1], srv[:1]), _ls_params(ref[:1], srv[:1])),
        ((ref, srv), _ls_params(ref, srv, solver="cholesky")),
        ((ref, srv), _ls_params(ref, srv, impl="segment")),
        ((ref, srv), _ls_params(ref, srv, filter_len=13)),
        ((ref, srv), _ls_params(ref, srv, bins=(0, 1, -1)))]


@pytest.mark.parametrize("kind", ["frames", "clutter"])
def test_graph_key_follows_every_route(monkeypatch, kind):
    """The batch graph's and the LS stage's key change with the fused-FFT
    opt-in and with the entry function of each kernel (B1, B2, B3, T1, L1),
    as chip_smoke.py's variant builds, float64 contexts and reference
    routes swap them; undone, it is the same key again. The LS stage's key
    also changes with shapes, solver, impl, filter length and bins."""
    inputs, params, others = _route_cases(kind)
    monkeypatch.delenv("PASSIVERADAR_PALLAS_FFT", raising=False)
    base = graphs.graph_key(kind, inputs, params)
    assert graphs.graph_key(kind, inputs, params) == base
    hash(base)
    keys = [base]
    monkeypatch.setenv("PASSIVERADAR_PALLAS_FFT", "1")
    keys.append(graphs.graph_key(kind, inputs, params))
    swaps = ((rk, "mix_regroup_matmul", rk.mix_regroup_matmul_plain),
             (nk, "nlms_filter_batch", nk.nlms_filter_batch_plain),
             (fk, "fft_fused", fk.fft_fused_reference),
             (fk, "fft_fused", lambda x, inverse=False: x),
             (tk, "multitarget_step_kernel", trackers.multitarget_step_plain),
             (lk, "levinson_first_col_kernel", lk.levinson_first_col_plain))
    for module, name, stand_in in swaps:
        monkeypatch.setattr(module, name, stand_in)
        keys.append(graphs.graph_key(kind, inputs, params))
    monkeypatch.undo()
    assert graphs.graph_key(kind, inputs, params) == base
    keys += [graphs.graph_key(kind, x, p) for x, p in others]
    assert len(set(keys)) == len(keys)


# ---- the cache, with a stand-in for the CUDA capture -------------------------

class _StandInGraph:
    """Replays ``run`` on the static inputs into the static outputs, as a
    captured graph would, without calling it through the cache."""

    def __init__(self, run, inputs, outputs):
        self.run, self.inputs, self.outputs = run, inputs, outputs

    def replay(self):
        out = self.run(*self.inputs)
        for dst, src in zip(self.outputs, graphs._tensors(out)):
            dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """The cache on CPU tensors: an empty cache of its own, the warm-up a
    plain call, the capture a _StandInGraph whose pool is ``pool`` bytes
    (added to a reserved-memory tally), and ``captured`` the runs that were
    captured."""
    state = dict(reserved=0, pool=100, captured=[])

    def record(inputs, run):
        out = run(*inputs)
        state["captured"].append(run)
        state["reserved"] += state["pool"]
        return _StandInGraph(run, inputs, graphs._tensors(out)), out

    monkeypatch.setattr(graphs, "_graphs", {})
    monkeypatch.setattr(graphs, "_warm_up", lambda inputs, run: run(*inputs))
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(graphs, "_reserved", lambda dev: state["reserved"])
    monkeypatch.setattr(graphs, "budget", lambda dev: 250)
    return state


def test_cache_keeps_its_budget_least_recently_used_first(stand_in):
    """Pools of 100 bytes under a 250-byte budget: the third key drops the
    least recently used (a replay makes a key the most recently used); a
    graph larger than the budget alone is still kept. cache_info names
    each graph's kind, key, pool bytes, times and replays, least recently
    used first."""
    x = torch.arange(4.0)

    def run(v):
        return v + 1

    for k in ("a", "b"):
        graphs.call("test", k, (x,), run, info=dict(name=k))
    graphs.call("test", "a", (x,), run)
    graphs.call("test", "c", (x,), run, info=dict(name="c"))
    info = graphs.cache_info()
    assert [g["key"]["name"] for g in info] == ["a", "c"]
    assert [g["replays"] for g in info] == [1, 0]
    assert all(g["kind"] == "test" and g["pool_bytes"] == 100
               and g["warmup_s"] >= 0 and g["capture_s"] >= 0
               and g["device"] == "cpu" for g in info)
    stand_in["pool"] = 1000
    graphs.call("test", "big", (x,), run, info=dict(name="big"))
    assert [g["key"]["name"] for g in graphs.cache_info()] == ["big"]


def test_cache_counts_launches_at_capture_and_replay(stand_in):
    """A run that launches the resampler kernel once: the key's first call
    counts its warm-up's launch and not the captured one; each replay adds
    the one launch the graph holds."""
    x = torch.arange(3.0)

    def run(v):
        rk.mix_regroup_matmul.launches += 1     # what a launch counts
        return v * 3

    before = rk.mix_regroup_matmul.launches
    graphs.call("test", "k", (x,), run)
    assert rk.mix_regroup_matmul.launches == before + 1
    entry = graphs.lookup("k", x.device)
    assert entry.launches == dict(mix_regroup_matmul=1)
    for i in range(3):
        graphs.call("test", "k", (x,), run)
        # the stand-in's replay runs ``run`` itself: +1 from it, +1 booked
        assert rk.mix_regroup_matmul.launches == before + 1 + 2 * (i + 1)
    assert entry.replays == 3


def test_cache_copies_inputs_and_returns_fresh_outputs(stand_in):
    """A replay reads the call's inputs through the static buffers and
    returns fresh tensors (a tuple where ``run`` returns one); with
    fresh=False the static outputs themselves; host inputs go to the
    device named."""
    def run(a, b):
        return a + b, a * b

    a, b = torch.arange(3.0), torch.ones(3)
    graphs.call("test", "k", (a, b), run)
    got = graphs.call("test", "k", (a + 1, b * 2), run)
    assert isinstance(got, tuple)
    assert got[0].equal(a + 1 + b * 2) and got[1].equal((a + 1) * b * 2)
    again = graphs.call("test", "k", (a, b), run)
    assert got[0].equal(a + 1 + b * 2)          # not overwritten
    static = graphs.call("test", "k", (a, b), run, fresh=False)
    entry = graphs.lookup("k", a.device)
    assert static[0] is entry.outputs[0] and again[0].equal(static[0])
    assert graphs.call("test", "k", (a, b), run, device="cpu")[0].equal(a + b)


@pytest.mark.parametrize("kind", sorted(tp._RUNS))
def test_entry_graphs_capture_the_eager_stage(stand_in, monkeypatch, kind):
    """Each entry point's graph function, captured and replayed through the
    cache (stand-in capture), gives the eager function's maps bit for bit;
    the graphed LS stage that it reaches while its graph is built (warm-up
    and capture) runs eagerly, and no graph but the entry point's is kept
    (a capture cannot start inside another)."""
    cfg = t_derive(TINY)
    ref, srv, ph = _frames(cfg, 4, pairs=True)
    r_if = tp._preprocess_impl(ref, ph, cfg)
    s_if = tp._preprocess_impl(srv, ph, cfg)
    clean = tp._clutter_impl(r_if, s_if, cfg)
    h = cfg.window_overlap
    edge = torch.zeros((1, h), dtype=torch.complex64)
    inputs = dict(
        preprocess=(ref, ph), caf=(r_if, clean), clean=(ref, srv, ph),
        frames=(ref, srv, ph),
        groups=(ref.reshape(2, 2, *ref.shape[1:]),
                srv.reshape(2, 2, *srv.shape[1:]), ph.reshape(2, 2)),
        halo_caf=(r_if, clean, edge, r_if[1:2, :h], edge,
                  clean[1:2, :h]))[kind]
    eager = functools.partial(tp._RUNS[kind], cfg=cfg)(*inputs)
    nested, graphed = [], graphs.graphed

    def spy(kind_, run_, inputs_, params_, **kw):
        nested.append((kind_, graphs._building))
        return graphed(kind_, run_, inputs_, params_, **kw)

    monkeypatch.setattr(graphs, "graphed", spy)
    run = functools.partial(tp._RUNS[kind], cfg=cfg)
    outs = [graphs.call(kind, kind, inputs, run)]
    building = list(nested)
    outs += [graphs.call(kind, kind, inputs, run) for _ in range(2)]
    assert len(stand_in["captured"]) == 1
    assert [g["kind"] for g in graphs.cache_info()] == [kind]
    assert bool(building) == (kind in ("clean", "frames", "groups"))
    assert all(k == "clutter" and depth == 1 for k, depth in building)
    for out in outs:
        for got, want in zip(graphs._tensors(out), graphs._tensors(eager)):
            assert torch.equal(_bits(got), _bits(want))


# ---- the entry points on CPU tensors ------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_process_frames_on_cpu_is_the_eager_chain(method):
    """process_frames and _process_frames_impl, bit for bit (NaN frames of
    'nlms' included), and no graph kept."""
    cfg = t_derive(dict(TINY, clutter_method=method))
    ref, srv, ph = _frames(cfg, 3)
    ref[0] = srv[0] = 0          # a zero margin frame
    got = tp.process_frames(ref, srv, ph, cfg, device="cpu")
    want = tp._process_frames_impl(ref, srv, ph, cfg)
    assert torch.equal(_bits(got), _bits(want))
    assert graphs.cache_info() == []


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_graphed_entry_points_on_cpu_match_jax(dtype):
    """preprocess_batch, caf_batch, process_frames and the stream's clean
    step on CPU tensors: each bit-equal to its eager function, and against
    the JAX package's entry points (int16 and float32 IQ pairs)."""
    params = dict(TINY, int16_scale=1.0 / 4096 if dtype == "int16" else 1.0)
    cfg_t, cfg_j = t_derive(params), j_derive(params)
    ref, srv, ph = _frames(cfg_t, 4, pairs=True)
    if dtype == "int16":
        ref = torch.round(ref * 4096).to(torch.int16)
        srv = torch.round(srv * 4096).to(torch.int16)
    r_if = tp.preprocess_batch(ref, ph, cfg_t, device="cpu")
    assert torch.equal(r_if, tp._preprocess_impl(ref, ph, cfg_t))
    j_r = np.asarray(jp.preprocess_batch(jnp.asarray(ref.numpy()),
                                         jnp.asarray(ph.numpy()), cfg_j))
    assert np.max(np.abs(r_if.numpy() - j_r)) < 1e-4 * np.max(np.abs(j_r))
    r_c, s_c = tp._clean_batch(ref, srv, ph, cfg_t, device="cpu")
    assert torch.equal(r_c, r_if)
    s_if = tp.preprocess_batch(srv, ph, cfg_t, device="cpu")
    assert torch.equal(s_c, tp.clutter_batch(r_if, s_if, cfg_t,
                                             device="cpu"))
    maps = tp.caf_batch(r_if, s_c, cfg_t, device="cpu")
    assert torch.equal(maps, tp._caf_batch_impl(r_if, s_c, cfg_t))
    want = np.asarray(jp.process_frames(
        jnp.asarray(ref.numpy()), jnp.asarray(srv.numpy()),
        jnp.asarray(ph.numpy()), cfg_j))
    got = tp.process_frames(ref, srv, ph, cfg_t, device="cpu")
    assert torch.equal(got, maps)
    _assert_maps_agree(got.numpy(), want)


def test_process_frames_groups_on_cpu_matches_jax():
    """Two groups of 2 frames: process_frames_groups on CPU tensors is each
    group's process_frames bit for bit, and agrees with the JAX package's
    grouped call."""
    cfg_t, cfg_j = t_derive(TINY), j_derive(TINY)
    ref, srv, _ = _frames(cfg_t, 4)
    refs, srvs = ref.reshape(2, 2, -1), srv.reshape(2, 2, -1)
    phs = torch.from_numpy(np.stack([tp.frame_phases(cfg_t, [0, 1]),
                                     tp.frame_phases(cfg_t, [2, 3])]))
    got = tp.process_frames_groups(refs, srvs, phs, cfg_t, device="cpu")
    for g in range(2):
        assert torch.equal(got[g], tp.process_frames(refs[g], srvs[g], phs[g],
                                                     cfg_t, device="cpu"))
    want = np.asarray(jp.process_frames_groups(
        jnp.asarray(refs.numpy()), jnp.asarray(srvs.numpy()),
        jnp.asarray(phs.numpy()), cfg_j))
    for g in range(2):
        _assert_maps_agree(got[g].numpy(), want[g])


@pytest.mark.parametrize("shards", [1, 2])
def test_shmap_graph_functions_on_cpu_match_process_frames(shards):
    """process_frames_shmap over CPU shards (the clean and halo_caf graph
    functions on each): one shard bit-equal to process_frames, two within
    the sharded-map bound of tests/test_torch_parallel.py (1e-3; argmax
    equal), and the JAX package's process_frames at the pipeline bound."""
    cfg_t, cfg_j = t_derive(TINY), j_derive(TINY)
    ref, srv, ph = _frames(cfg_t, 4)
    mesh = make_mesh(devices=["cpu"] * shards)
    got = torch.cat(tp.process_frames_shmap(ref, srv, ph, cfg_t, mesh))
    one = tp.process_frames(ref, srv, ph, cfg_t, device="cpu")
    if shards == 1:
        assert torch.equal(got, one)
    else:
        assert (got - one).abs().max() < 1e-3 * one.abs().max()
    want = np.asarray(jp.process_frames(
        jnp.asarray(ref.numpy()), jnp.asarray(srv.numpy()),
        jnp.asarray(ph.numpy()), cfg_j))
    _assert_maps_agree(got.numpy(), want)


def test_stream_caf_cfar_on_cpu_is_the_eager_step():
    """The stream's CAF + CFAR step (one graph on the card) on CPU tensors:
    the eager fast_xambg and cfar_2d of the halo-extended frame, bit for
    bit."""
    from passiveradar_torch.ops.caf import fast_xambg
    from passiveradar_torch.ops.cfar import cfar_2d
    cfg = t_derive(TINY)
    sp = ts.StreamingProcessor(cfg, device="cpu")
    ref, srv, ph = _frames(cfg, 3)
    sp.push(ref[0], srv[0])
    res = sp.push(ref[1], srv[1])
    r, s = tp._clean_impl(ref[0:1], srv[0:1], ph[0:1], cfg)
    nxt = tp._clean_impl(ref[1:2], srv[1:2], ph[1:2], cfg)
    h = cfg.window_overlap
    z = torch.zeros(h, dtype=torch.complex64)
    caf = fast_xambg(torch.cat([z, r[0], nxt[0][0, :h]]),
                     torch.cat([z, s[0], nxt[1][0, :h]]),
                     cfg.num_range_cells, cfg.num_doppler_cells,
                     window=sp._window, short_filt=cfg.caf_short_filt)
    np.testing.assert_array_equal(res.caf, caf.numpy())
    np.testing.assert_array_equal(res.cfar, cfar_2d(caf.abs(),
                                                    *sp.cfar_kernel).numpy())
