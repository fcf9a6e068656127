"""The benchmark's NLMS deployment (``benchmark/configs/fm_nlms.json``, cell
``fm_nlms_ring``) on the CPU: the reference NLMS (benchmark/reference/
nlms.py) against the port's plain NLMS, the reference's FM clean stage and
maps against ``pipeline.run_capture`` under ``nlms_pallas``, a small copy
of the cell through the harness (correct, traced and untraced), planted
faults that read not correct, B2's frozen count, and the new readers on an
empty trace."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from benchmark.core import cells, harness, scene, work, work_nlms
from benchmark.reference import geometry, pipelines
from benchmark.reference import nlms as ref_nlms
from benchmark.reference.precision import FP64, TF32
from benchmark.tests import tiny
from benchmark.traffic import ring_capture
from passiveradar_torch.ops import graphs
from passiveradar_torch.ops import nlms_kernel as nk

CELL = "fm_nlms_ring"
TINY = "tiny_fm_nlms_ring"
METRICS = ("b2_roofline.capture", "b2_ms.capture")


def _cnoise(gen, shape):
    return torch.complex(torch.randn(shape, generator=gen,
                                     dtype=torch.float64),
                         torch.randn(shape, generator=gen,
                                     dtype=torch.float64))


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---- (a) the reference NLMS against the port's plain NLMS -------------------

@pytest.mark.parametrize("filter_len,peek", [(2, 10), (12, 0), (175, 10)])
@pytest.mark.parametrize("zero_run", [False, True])
def test_reference_nlms_is_the_ports_plain_nlms(filter_len, peek, zero_run):
    """Seeded frames, each a clutter of a few delays in noise. The port
    runs in complex64 and the reference in complex128: their outputs
    differ by the float32 rounding of the recurrence, under 2e-5 of the
    largest output sample (float32's 6e-8 grown by the n − m dependent
    steps and the m-term sums; measured 8e-8–5e-7). With ``zero_run``
    one frame holds an all-zero run longer than the taps, so the guard
    "zero" keeps its taps through it: finite in both, and equal."""
    gen = torch.Generator().manual_seed(filter_len + 7 * peek)
    f, n = 3, 3000
    ref = _cnoise(gen, (f, n))
    if zero_run:
        ref[1, 900:1400] = 0
    srv = (0.5 * torch.roll(ref, 3, -1) + 0.2 * torch.roll(ref, 7, -1)
           + 0.05 * _cnoise(gen, (f, n)))
    want = ref_nlms.nlms(ref, srv, filter_len, 0.05, peek=peek)
    got = nk.nlms_filter_batch_plain(ref.to(torch.complex64),
                                     srv.to(torch.complex64), filter_len,
                                     0.05, peek=peek, zero_window="zero")
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    m = filter_len + peek
    assert (want[:, :filter_len] == 0).all()
    assert (want[:, filter_len + n - m:] == 0).all()
    assert _err(got.numpy(), want.numpy()) < 2e-5


def test_reference_nlms_control_rounds_to_tf32():
    """The control (TF32 operands) is farther from the reference than the
    port's float32 by orders of magnitude: what the cell's limit sits
    between."""
    gen = torch.Generator().manual_seed(3)
    ref = _cnoise(gen, (2, 3000))
    srv = 0.5 * torch.roll(ref, 3, -1) + 0.05 * _cnoise(gen, (2, 3000))
    want = ref_nlms.nlms(ref, srv, 12, 0.05).numpy()
    port = nk.nlms_filter_batch_plain(ref.to(torch.complex64),
                                      srv.to(torch.complex64), 12, 0.05)
    control = ref_nlms.nlms(ref, srv, 12, 0.05, TF32)
    assert control.dtype == torch.complex64
    assert _err(control.numpy(), want) > 30 * _err(port.numpy(), want)


# ---- (b) the FM clean stage and maps against run_capture --------------------

def _params():
    return dict(tiny._load(f"{tiny.BENCH}/configs/fm_nlms.json"), **tiny.FM)


def test_fm_clean_and_maps_match_run_capture():
    """Six frames of the cell's scene (targets brought inside the small
    geometry's range) through ``run_capture`` with ``nlms_pallas``: every
    map within 5e-5 of the reference's peak (the port's float32 NLMS and
    CAF; measured 2.4e-6), its peak in the same cell."""
    from passiveradar_torch import derive_config, pipeline
    p = _params()
    g = geometry.derive(p)
    mix = tiny._load(f"{tiny.BENCH}/traffic/fm_nlms_capture_calls.json")
    for t in mix["scene"]["targets"]:
        t["delay_samples"] = max(1, t["delay_samples"] // 50)
    f = 6
    ref, srv = scene.make_ring(g, mix["scene"], f, 7, "cpu")
    pairs = [scene.to_int16_pairs(x, g["int16_scale"]) for x in (ref, srv)]
    cfg = derive_config(dict(p, num_frames=f))
    assert cfg.clutter_method == "nlms_pallas" and cfg.nlms_mu == 0.05
    sink = ring_capture.Sink(range(f))
    pipeline.run_capture(ring_capture.RingReader(*pairs, f, 0, f), sink,
                         cfg, progress=False, device="cpu")
    raw = [torch.from_numpy(x.astype(np.float64) * g["int16_scale"])
           for x in pairs]
    r, s = ref_nlms.fm_clean(*(torch.complex(x[..., 0], x[..., 1])
                               for x in raw), range(f), g, 0.05)
    want = pipelines.fm_maps(r, s, g).numpy()
    for i in range(f):
        assert _err(sink.kept[i], want[i]) < 5e-5
        assert np.argmax(np.abs(sink.kept[i])) == np.argmax(np.abs(want[i]))


# ---- (c), (d) a small copy of the cell through the harness ------------------

def make_copy(dst: str) -> str:
    """``tiny.make_copy`` with a small copy of fm_nlms_ring added as new
    files and entries: fm_nlms at tiny.FM's geometry, the mix with
    tiny_fm_ring's short ring. Returns the copy's benchmark directory."""
    bench = tiny.make_copy(dst)
    spec = cells.load_json(os.path.join(dst, "BENCHMARK.json"))
    real = next(w for w in spec["workloads"] if w["name"] == CELL)
    config = next(c for c in spec["configs"] if c["name"] == real["config"])
    mix = dict(tiny._load(f"{tiny.BENCH}/traffic/{real['traffic']}.json"),
               **tiny.CELLS["tiny_fm_ring"][2])
    for t in mix["scene"]["targets"]:
        t["delay_samples"] = max(1, t["delay_samples"] // 50)
    tiny._dump(_params(), os.path.join(bench, "configs", TINY + ".json"))
    tiny._dump(mix, os.path.join(bench, "traffic", TINY + ".json"))
    tiny._dump(tiny._load(f"{tiny.BENCH}/workloads/{CELL}.json"),
               os.path.join(bench, "workloads", TINY + ".json"))
    spec["configs"].append(dict(config, name=TINY,
                                file=f"benchmark/configs/{TINY}.json"))
    spec["workloads"].append(dict(real, name=TINY, config=TINY,
                                  traffic=TINY))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    tiny._dump(spec, os.path.join(dst, "BENCHMARK.json"))
    return bench


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("traced", [False, True])
def test_small_cell_runs_correct(copy, traced):
    r = harness.run(TINY, 2**33 + 9, 0.5, traced, device="cpu", root=copy)
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["map_err"]
    assert r["attempted"] > 0 and r["failed"] == 0
    cell = cells.find(TINY, copy)
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} >= set(METRICS)


def _faulty_nlms(fault):
    """The port's NLMS with one fault: μ 10% high, or the tap update of
    one step (a third of the way in) skipped."""
    plain = nk.nlms_filter_batch_plain
    if fault == "mu":
        return lambda ref, srv, filter_len, mu, **k: plain(
            ref, srv, filter_len, 1.1 * mu, **k)

    def skipped(ref, srv, filter_len, mu, peek=10, zero_window="zero",
                **_):
        ref, srv = ref.to(torch.complex64), srv.to(torch.complex64)
        b, n = ref.shape
        m = filter_len + peek
        windows = ref[:, 1:].unfold(-1, m, 1)
        uu = (ref.real ** 2 + ref.imag ** 2)[:, 1:].unfold(-1, m, 1).sum(-1)
        w = torch.zeros((b, m), dtype=torch.complex64)
        out = torch.zeros_like(ref)
        for k in range(n - m):
            u = windows[:, k]
            e = srv[:, filter_len + k] - torch.linalg.vecdot(w, u)
            out[:, filter_len + k] = e
            if k != (n - m) // 3:
                w = w + u * (e.conj() * mu / uu[:, k].clamp_min(1e-30)
                             ).unsqueeze(-1)
        return out
    return skipped


@pytest.mark.parametrize("fault", ["mu", "one_step_skipped", "ls"])
def test_planted_fault_is_not_correct(copy, monkeypatch, fault):
    if fault == "ls":
        from passiveradar_torch import pipeline
        clutter = pipeline._clutter_impl
        monkeypatch.setattr(pipeline, "_clutter_impl",
                            lambda ref, srv, cfg, *a, **k: clutter(
                                ref, srv, dataclasses.replace(
                                    cfg, clutter_method="ls_multiple"),
                                *a, **k))
    else:
        monkeypatch.setattr(nk, "nlms_filter_batch", _faulty_nlms(
            "mu" if fault == "mu" else "skip"))
    r = harness.run(TINY, 11, 0.3, False, device="cpu", root=copy)
    assert r["correct"] is False, r["checks"]


def test_control_is_not_correct_and_float64_is(copy):
    """The cell's control, judged by its check at the small size: TF32
    operands read not correct, the float64 reference against itself
    reads 0."""
    from benchmark import control
    from benchmark.reference.precision import Precision
    cell = cells.find(TINY, copy)
    assert control.judged(cell, 5, torch.device("cpu"),
                          Precision("tf32"))["correct"] is False
    same = control.judged(cell, 5, torch.device("cpu"), FP64)
    assert same["correct"] is True
    assert same["checks"]["map_err"]["value"] == 0.0


# ---- (e) B2's frozen count --------------------------------------------------

def test_work_nlms_is_chip_smokes_count_at_the_fm_shape():
    """chip_smoke.py's B2 bound (16·m·steps·f operations, 3·f·n·8 bytes),
    at the FM batch: 10 frames of 262,144 samples, 185 taps: 7.75 GFLOP,
    0.1157 ms at 67 TFLOP/s."""
    src = open(os.path.join(tiny.REPO, "chip_smoke.py")).read()
    assert re.search(r"flops = 16\.0 \* m \* steps \* f\b", src)
    assert re.search(r"nbytes = 3\.0 \* f \* big_n \* 8\b", src)
    cell = cells.find(CELL)
    g = geometry.derive(cell.config)
    f, n, m = cell.config["frame_batch"] + 2, g["out_len"], \
        g["num_range_cells"] + 10
    assert (f, n, m) == (10, 262_144, 185)
    flops, nbytes = work_nlms.b2_nlms(f, n, m)
    assert flops == 16.0 * m * (n - m) * f and nbytes == 3.0 * f * n * 8
    assert round(flops / 1e9, 2) == 7.75
    assert round(work.bound_s(flops, nbytes) * 1e3, 4) == 0.1157


# ---- (f) the new readers on an empty trace, and the counter -----------------

@pytest.mark.parametrize("metric", METRICS)
def test_new_reader_reads_nothing_from_an_empty_trace(metric):
    cell = cells.find(CELL)
    ctx = harness.Context([], [], 1.0, 0, cell, geometry.derive(cell.config))
    assert cell.reader(metric).read(ctx) is None
    assert ctx.notes and metric in ctx.notes[0]


def test_readers_read_b2_from_its_launches():
    """Two batches, each one 20 ms launch of the kernel among others: 20 ms
    a batch, and the frozen bound over 20 ms."""
    from benchmark.core import trace
    cell = cells.find(CELL)
    ops = [trace.Op("void nlms_kernel<64>(float2 const*)", "kernel",
                    i * 10**8, i * 10**8 + 2 * 10**7, 0) for i in range(2)]
    ops.append(trace.Op("void mix_regroup_kernel()", "kernel", 5, 10**6, 0))
    ctx = harness.Context(ops, [], 1.0, 2, cell, geometry.derive(cell.config))
    assert cell.reader("b2_ms.capture").read(ctx) == pytest.approx(20.0)
    share = cell.reader("b2_roofline.capture").read(ctx)
    assert share == pytest.approx(100 * 0.1157e-3 / 20e-3, rel=1e-3)


def test_graph_replay_counts_the_frames_filtered(monkeypatch):
    """A graph whose run filters 10 frames in one launch: the capture takes
    its launch and frames off again, each replay adds them."""
    monkeypatch.setattr(graphs, "_graphs", {})
    monkeypatch.setattr(graphs, "_warm_up", lambda inputs, run: run(*inputs))

    class Replayed:
        def __init__(self, run, inputs):
            self.run, self.inputs = run, inputs

        def replay(self):
            self.run(*self.inputs)

    monkeypatch.setattr(graphs, "_record", lambda inputs, run: (
        Replayed(run, inputs), run(*inputs)))
    monkeypatch.setattr(graphs, "_reserved", lambda dev: 0)
    monkeypatch.setattr(graphs, "budget", lambda dev: 1)

    def run(v):
        nk.nlms_filter_batch.launches += 1      # what a launch counts
        nk.nlms_filter_batch.frames += 10
        return v + 1

    x = torch.zeros(3)
    launches, frames = nk.nlms_filter_batch.launches, \
        nk.nlms_filter_batch.frames
    graphs.call("test", "k", (x,), run)
    assert (nk.nlms_filter_batch.launches, nk.nlms_filter_batch.frames) == (
        launches + 1, frames + 10)
    entry = graphs.lookup("k", x.device)
    assert entry.launches == dict(nlms_filter_pallas=1)
    graphs.call("test", "k", (x,), run)
    # the stand-in's replay runs ``run`` itself (+1, +10), and the replay
    # adds the graph's own (+1, +10)
    assert (nk.nlms_filter_batch.launches, nk.nlms_filter_batch.frames) == (
        launches + 3, frames + 30)
