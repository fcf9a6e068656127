"""graph_captures.capture: the graphs warmed up and captured inside the
window (``graph.capture/<kind>`` spans of ``ops/graphs``), a count: above
0, a batch graph was built again (an eviction, or a key that changes from
call to call); nothing where the trace holds no ``capture.batch`` span
(moves frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.captures(ctx, "graph_captures.capture", "capture.batch")
