"""host_write_ms.capture: the writers' calls (the per-channel map writers
and the integrated stack), in ms a batch: the median over the window's
``capture.batch`` spans of the ``capture.write`` span inside each (moves
frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "host_write_ms.capture",
                                 "capture.batch", "capture.write")
