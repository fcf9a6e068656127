"""device_idle.stream: the share of the traced window, in %, in which the
card ran no kernel and no copy, over the closed loop of pushes (moves
push_ms_p50)."""

from benchmark.core import trace


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        ctx.note("device_idle.stream: no device operation in the trace")
        return None
    return 100.0 * (1.0 - trace.busy_ns(ctx.ops) * 1e-9 / ctx.window_s)
