"""push_device_ms.stream: the card's busy time (kernels and copies as a
union), in ms, a push: the traced window's busy time over its pushes
(moves push_ms_p50)."""

from benchmark.core import trace


def read(ctx):
    if not ctx.ops or ctx.units <= 0:
        ctx.note("push_device_ms.stream: no push or no device operation")
        return None
    return trace.busy_ns(ctx.ops) * 1e-6 / ctx.units
