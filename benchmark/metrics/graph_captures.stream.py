"""graph_captures.stream: the graphs warmed up and captured inside the
window (``graph.capture/<kind>`` spans of ``ops/graphs``), a count: above
0, a push's graph was built again (an eviction, or a key that changes from
push to push); nothing where the trace holds no ``push`` span (moves
push_ms_p50)."""

from benchmark.core import spans


def read(ctx):
    return spans.captures(ctx, "graph_captures.stream", "push")
