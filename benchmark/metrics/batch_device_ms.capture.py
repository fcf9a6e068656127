"""batch_device_ms.capture: the card's busy time (kernels and copies as a
union), in ms, a batch: the traced window's busy time over the batches it
ran (moves frames_per_s)."""

from benchmark.core import trace


def read(ctx):
    if not ctx.ops or ctx.units <= 0:
        ctx.note("batch_device_ms.capture: no batch or no device operation")
        return None
    return trace.busy_ns(ctx.ops) * 1e-6 / ctx.units
