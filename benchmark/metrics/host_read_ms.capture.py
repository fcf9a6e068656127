"""host_read_ms.capture: the host loop's wait on the prefetch reader's
queue, in ms a batch: the median over the window's ``capture.batch`` spans
of the ``capture.read`` span inside each (moves frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "host_read_ms.capture",
                                 "capture.batch", "capture.read")
