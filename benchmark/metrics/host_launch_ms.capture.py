"""host_launch_ms.capture: the host's enqueue of a batch's device work
(FM: the copies into the batch graph, its replay and the copy out into
pinned memory; wideband: ``wideband_frames``, its pageable copy and the
eager channelizer included), in ms a batch: the median over the window's
``capture.batch`` spans of the ``capture.launch`` span inside each (moves
frames_per_s)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "host_launch_ms.capture",
                                 "capture.batch", "capture.launch")
