"""b2_ms.capture: B2's (``csrc/nlms.cu``, the NLMS canceller) device time a
batch, in ms: every ``nlms_kernel`` launch in the traced window, inside
graph replays too, summed over the batches the window ran (moves
frames_per_s)."""

from benchmark.core import trace


def read(ctx):
    runs = trace.launches(ctx.ops, "nlms_kernel")
    if not runs or ctx.units <= 0:
        ctx.note("b2_ms.capture: no kernel named *nlms_kernel* in the trace, "
                 "or no batch")
        return None
    return sum(o.end - o.start for o in runs) * 1e-6 / ctx.units
