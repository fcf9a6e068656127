"""The program's own spans in the traced window: the named host events
that the port records into the running profiler
(``passiveradar_torch/spans.py``), among the trace's host spans
(``core/trace.Profile``). A parent span (``capture.batch``, ``push``)
holds its children (``capture.read`` ... ``capture.write``,
``push.upload`` ... ``push.fetch``); a program without these spans gives
nothing to read.
"""

from __future__ import annotations

import bisect
import statistics


def named(spans, name: str) -> list:
    """The spans called ``name``, in order of their start."""
    return sorted((s for s in spans if s.name == name),
                  key=lambda s: s.start)


def child_ms(spans, parent: str, child: str) -> list:
    """For each span called ``parent``, the summed length in ms of the
    spans called ``child`` that lie inside it (0 where it has none)."""
    parents = named(spans, parent)
    starts = [p.start for p in parents]
    total = [0] * len(parents)
    for c in named(spans, child):
        i = bisect.bisect_right(starts, c.start) - 1
        if i >= 0 and c.end <= parents[i].end:
            total[i] += c.end - c.start
    return [ns * 1e-6 for ns in total]


def median_child_ms(ctx, metric: str, parent: str, child: str):
    """The median over the window's ``parent`` spans of ``child_ms``, or
    None (with a note) where the trace holds no ``parent`` span."""
    per = child_ms(ctx.spans, parent, child)
    if not per:
        ctx.note(f"{metric}: no {parent} span in the trace (a program "
                 "that records no spans)")
        return None
    return statistics.median(per)


def captures(ctx, metric: str, presence: str):
    """The graphs warmed up and captured in the window
    (``graph.capture/<kind>`` spans), or None (with a note) where the
    trace holds no ``presence`` span."""
    if not any(s.name == presence for s in ctx.spans):
        ctx.note(f"{metric}: no {presence} span in the trace (a program "
                 "that records no spans)")
        return None
    return sum(1 for s in ctx.spans if s.name.startswith("graph.capture/"))
