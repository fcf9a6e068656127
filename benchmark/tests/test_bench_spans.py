"""The per-layer metrics that read the port's own spans (core/spans.py and
the readers of host_*_ms.capture, push_*_ms.stream and graph_captures.*):
a traced run of each small cell on the CPU reads every one of its cell,
each with a value, no graph captured in the window; the readers' sums and
counts on spans made by hand."""

import pytest

from benchmark.core import cells, harness, spans
from benchmark.core.trace import Span
from benchmark.tests import tiny

SPAN_METRICS = {
    "ring": ["host_read_ms.capture", "host_stage_ms.capture",
             "host_launch_ms.capture", "host_wait_ms.capture",
             "host_write_ms.capture", "graph_captures.capture"],
    "stream": ["push_upload_ms.stream", "push_launch_ms.stream",
               "push_fetch_ms.stream", "graph_captures.stream"],
}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_traced_run_reads_every_span_metric(copy, name):
    r = harness.run(name, 2**33 + 7, 0.5, True, device="cpu", root=copy)
    assert r["correct"] is True, r["checks"]
    want = SPAN_METRICS["ring" if name.endswith("ring") else "stream"]
    assert set(want) <= {m["name"] for m in cells.find(name, copy).per_layer}
    for metric in want:
        value = r["metrics"][metric]["value"]
        if metric.startswith("graph_captures."):
            assert value == 0.0
        else:
            assert value > 0.0, metric


def test_child_ms_sums_the_children_inside_each_parent():
    """Children sum within their parent; a parent without the child reads
    0; a child outside every parent is left out; the median is over
    parents."""
    ms = 1_000_000
    found = [Span("push", 0, 10 * ms), Span("push.launch", 1 * ms, 3 * ms),
             Span("push.launch", 4 * ms, 5 * ms),
             Span("push", 20 * ms, 30 * ms),
             Span("push", 40 * ms, 50 * ms),
             Span("push.launch", 41 * ms, 45 * ms),
             Span("push.launch", 60 * ms, 61 * ms)]
    assert spans.child_ms(found, "push", "push.launch") == [3.0, 0.0, 4.0]
    ctx = harness.Context([], found, 1.0, 3, None, {})
    assert spans.median_child_ms(ctx, "m", "push", "push.launch") == 3.0
    assert spans.captures(ctx, "m", "push") == 0
    ctx = harness.Context([], found + [
        Span("graph.capture/clean", 21 * ms, 22 * ms)], 1.0, 3, None, {})
    assert spans.captures(ctx, "m", "push") == 1
    assert spans.captures(ctx, "m", "capture.batch") is None and ctx.notes
