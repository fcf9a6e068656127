"""device_idle.capture: the share of the traced window, in %, in which the
card ran no kernel and no copy, over back-to-back captures (moves
frames_per_s)."""

from benchmark.core import trace


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        ctx.note("device_idle.capture: no device operation in the trace")
        return None
    return 100.0 * (1.0 - trace.busy_ns(ctx.ops) * 1e-9 / ctx.window_s)
