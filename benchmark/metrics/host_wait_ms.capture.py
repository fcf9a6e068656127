"""host_wait_ms.capture: the host blocked until a batch's maps are on the
host (FM: the previous batch's event; wideband: the copies to the host),
in ms a batch: the median over the window's ``capture.batch`` spans of the
``capture.wait`` span inside each (moves frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "host_wait_ms.capture",
                                 "capture.batch", "capture.wait")
