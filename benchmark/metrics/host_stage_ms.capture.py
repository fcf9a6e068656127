"""host_stage_ms.capture: the host loop's copies of a batch into the
buffers the card reads (FM: the pinned int16 buffers and the phases;
wideband: the numpy buffers), in ms a batch: the median over the window's
``capture.batch`` spans of the ``capture.stage`` span inside each (moves
frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "host_stage_ms.capture",
                                 "capture.batch", "capture.stage")
