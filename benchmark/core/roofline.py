"""A hand-written kernel's share of its roofline from the trace: the frozen
bound of one launch (core/work.py) over the kernel's mean device time a
launch, in %. The kernel is found by name, inside graph replays too."""

from __future__ import annotations

from benchmark.core import trace, work


def share(ctx, metric: str, needle: str, flops: float,
          nbytes: float):
    runs = trace.launches(ctx.ops, needle)
    if not runs:
        ctx.note(f"{metric}: no kernel named *{needle}* in the trace")
        return None
    mean_s = sum(o.end - o.start for o in runs) * 1e-9 / len(runs)
    return 100.0 * work.bound_s(flops, nbytes) / mean_s
