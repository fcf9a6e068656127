"""The port's spans (passiveradar_torch/spans.py), on the CPU.

* With no profiler running a span makes no recorder; under one it records
  its name, nested inside the span around it, as a function-scope event
  (not a user annotation, which would also put a span on the device's
  timeline).
* The host loops (pipeline.run_capture, wideband.run_wideband_capture)
  record one ``capture.open`` a call before its batches and one
  ``capture.batch`` a batch, its children disjoint and inside it; the
  streaming processors' push, flush and fetch_maps record ``push`` with
  their children; a graph's first call records one
  ``graph.capture/<kind>``, a replay none.
* ``cli.process --profile`` and ``cli.stream --profile`` write these
  spans into their Chrome trace.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
import yaml

from passiveradar_torch import spans
from passiveradar_torch import streaming as ts
from passiveradar_torch import wideband as twb
from passiveradar_torch.cli import process as cli_process
from passiveradar_torch.cli import stream as cli_stream
from passiveradar_torch.config import derive_config
from passiveradar_torch.io.synthetic import synth_capture_arrays, \
    wideband_capture_arrays, write_synth_capture
from passiveradar_torch.ops import graphs
from passiveradar_torch.pipeline import run_capture
from tests.test_torch_graphs import stand_in  # noqa: F401  (a fixture)

torch.set_num_threads(1)

# tests/test_torch_pipeline.py's TINY geometry and tests/test_wideband.py's
# 4-channel band
FM = dict(input_sample_rate=49152, input_center_freq=1_000_000,
          channel_freq=990_170, channel_bandwidth=12800,
          cpi_seconds_nominal=1.0, max_doppler_nominal=128.0,
          max_range_nominal=400.0, overlap_cpi=True, frame_batch=4,
          num_frames=10)
WB = dict(input_sample_rate=65536, input_center_freq=0, channel_freq=0,
          channel_bandwidth=65536, cpi_seconds_nominal=0.25,
          max_doppler_nominal=128.0, max_range_nominal=150.0,
          wideband_channels=4, wideband_channel_select=(1, 2),
          frame_batch=2, num_frames=5)
CAPTURE = ("capture.read", "capture.stage", "capture.launch",
           "capture.wait", "capture.write")


class _Reader:
    """A capture held in memory, served as views (the CaptureReader
    interface)."""

    def __init__(self, ref, srv):
        self.ref, self.srv = ref, srv
        self.num_frames = len(ref)
        self.pair_dtype = ref.dtype

    def read_pair_frames(self, start, count):
        return self.ref[start:start + count], self.srv[start:start + count]

    read_iq_frames = read_pair_frames


class _Sink:
    """The MapWriter interface, counting the frames written."""

    frames_done = 0

    def __init__(self):
        self.written = 0

    def write(self, frames, start):
        self.written += len(frames)


def _recorded(fn):
    """fn() under the profiler: its result, and the port's spans it
    recorded as (name, start, end) in order of their start (µs)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(("capture.", "push", "graph.",
                                           "test."))),
                    key=lambda e: (e[1], -e[2]))
    return out, events


def _opens_first(events) -> None:
    """One ``capture.open`` span, first, ending before any other span
    starts."""
    names = [ev[0] for ev in events]
    assert names[0] == "capture.open" and names.count("capture.open") == 1
    assert events[0][2] <= min(ev[1] for ev in events[1:])


def _children(events, parent: str) -> list:
    """For each span called ``parent``, the names of the spans inside it,
    in order, each checked to end before the next one starts."""
    out = []
    for name, s, e in events:
        if name != parent:
            continue
        inner = [ev for ev in events if ev[0] != parent and
                 s <= ev[1] and ev[2] <= e]
        for a, b in zip(inner, inner[1:]):
            assert a[2] <= b[1], (a, b)          # disjoint
        out.append([ev[0] for ev in inner])
    return out


def test_span_makes_no_recorder_without_a_profiler(monkeypatch):
    """Off, a span is one check of the profiler's flag: the recorder is
    never made (a stand-in counts what is made); on, it is made once a
    span."""
    made = []

    def recorder(name):
        made.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(spans, "_Record", recorder)
    for _ in range(3):
        with spans.span("capture.batch"):
            pass
    assert made == []

    def on():
        with spans.span("capture.batch"):
            pass

    _recorded(on)
    assert made == ["capture.batch"]


def test_span_records_nested_names_under_the_profiler():
    """Each span is an event of its name, the inner one inside the outer
    one, and none is a user annotation."""
    def run():
        with spans.span("test.outer"):
            with spans.span("test.inner"):
                torch.ones(8).sum()

    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    ev = {e.name: e for e in prof.events() if e.name.startswith("test.")}
    assert set(ev) == {"test.outer", "test.inner"}
    outer, inner = ev["test.outer"].time_range, ev["test.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert not any(e.is_user_annotation for e in ev.values())


def test_run_capture_records_a_batch_span_a_batch():
    """Three batches of a 10-frame FM capture, after one
    ``capture.open``: each ``capture.batch`` holds its read, stage and
    launch, and after the first the previous batch's wait and write,
    disjoint and in that order; the last batch's wait and write follow the
    loop, outside every batch."""
    cfg = derive_config(FM)
    n = cfg.input_chunk_length
    ref, srv = synth_capture_arrays(cfg, FM["num_frames"], seed=3)
    shape = (FM["num_frames"], n // 2, 2)
    reader = _Reader(ref[:FM["num_frames"] * n].reshape(shape),
                     srv[:FM["num_frames"] * n].reshape(shape))
    sink = _Sink()
    total, events = _recorded(lambda: run_capture(
        reader, sink, cfg, progress=False, device="cpu"))
    assert total == sink.written == 10
    _opens_first(events)
    kids = _children(events, "capture.batch")
    assert kids == [list(CAPTURE[:3])] + [list(CAPTURE)] * 2
    names = [e[0] for e in events]
    assert names.count("capture.wait") == names.count("capture.write") == 3
    assert names[-2:] == ["capture.wait", "capture.write"]
    assert not any(name.startswith("graph.") for name in names)


def test_run_wideband_capture_records_a_batch_span_a_batch(tmp_path):
    """Three batches of a 5-CPI wideband capture with the integrated
    stack, after one ``capture.open``: each ``capture.batch`` holds its
    read, stage, launch, wait and write, disjoint and in that order."""
    cfg = derive_config(dict(WB, output_fname=str(tmp_path / "WB")))
    ref, srv = (x.view(np.complex64).reshape(WB["num_frames"], -1)
                for x in wideband_capture_arrays(cfg, WB["num_frames"]))
    sinks = {k: _Sink() for k in WB["wideband_channel_select"]}
    total, events = _recorded(lambda: twb.run_wideband_capture(
        _Reader(ref, srv), cfg, writers=sinks, progress=False,
        integrate=True, device="cpu"))
    assert total == 5 and all(s.written == 5 for s in sinks.values())
    _opens_first(events)
    assert _children(events, "capture.batch") == [list(CAPTURE)] * 3


def test_stream_push_flush_and_fetch_record_push_spans():
    """FM: the first push uploads and launches; each later push also
    launches the previous frame's CAF and tracker step and fetches its
    result; the flush launches and fetches; fetch_maps fetches."""
    cfg = derive_config(FM)
    n = cfg.input_chunk_length
    ref, srv = synth_capture_arrays(cfg, 3, seed=5)
    sp = ts.StreamingProcessor(cfg, n_tracks=4, device="cpu")

    def run():
        for f in range(3):
            sp.push(ref[f * n:(f + 1) * n], srv[f * n:(f + 1) * n])
        sp.flush()
        sp.fetch_maps()

    _, events = _recorded(run)
    up, launch, fetch = "push.upload", "push.launch", "push.fetch"
    assert _children(events, "push") == [
        [up, launch], [up, launch, launch, fetch],
        [up, launch, launch, fetch], [launch, fetch], [fetch]]


def test_wideband_push_and_fetch_record_push_spans():
    """Wideband: each push uploads, launches and fetches; fetch_maps
    fetches."""
    cfg = derive_config(WB)
    ref, srv = (x.view(np.complex64).reshape(2, -1)
                for x in wideband_capture_arrays(cfg, 2))
    sp = twb.WidebandStreamingProcessor(cfg, n_tracks=4, device="cpu")

    def run():
        for f in range(2):
            sp.push(ref[f], srv[f])
        sp.fetch_maps()

    _, events = _recorded(run)
    assert _children(events, "push") == [
        ["push.upload", "push.launch", "push.fetch"]] * 2 + [["push.fetch"]]


@pytest.mark.parametrize("kind", ["clean", "frames"])
def test_graph_capture_span_on_first_call_only(stand_in, kind):  # noqa: F811
    """A key's first call records one ``graph.capture/<kind>`` span (its
    warm-up and capture); its replays record none."""
    x = torch.arange(4.0)

    def run(v):
        return v * 2

    _, first = _recorded(lambda: graphs.call(kind, "k", (x,), run))
    _, again = _recorded(lambda: [graphs.call(kind, "k", (x,), run)
                                  for _ in range(2)])
    assert [e[0] for e in first] == [f"graph.capture/{kind}"]
    assert again == []
    assert len(stand_in["captured"]) == 1


@pytest.mark.parametrize("cli,spans_of", [
    (cli_process, ("capture.open", "capture.batch") + CAPTURE),
    (cli_stream, ("push", "push.upload", "push.launch", "push.fetch"))],
    ids=["process", "stream"])
def test_cli_profile_trace_holds_the_spans(tmp_path, cli, spans_of):
    """``--profile DIR`` of each CLI writes one Chrome trace holding the
    host loop's or the pushes' spans."""
    params = dict(FM, num_frames=3, input_file=str(tmp_path / "cap.hdf5"),
                  output_fname=str(tmp_path / "OUT"))
    write_synth_capture(params["input_file"], derive_config(params), 3)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(params))
    trace_dir = tmp_path / "trace"
    cli.main(["--config", str(path), "--device", "cpu",
              "--profile", str(trace_dir)])
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert set(spans_of) <= names
