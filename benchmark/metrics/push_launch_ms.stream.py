"""push_launch_ms.stream: the host's enqueue of a push's device work (the
graphs, the eager channelizer, the tracker step), in ms a push: the median
over the window's ``push`` spans of the ``push.launch`` spans inside each,
summed (moves push_ms_p50).

Inflated by the profiler: the traced run records every aten op the
launch enqueues (the eager channelizer and the tracker step are many
small ops), which about doubles the launch's host time. On an H100's
host a wideband push's launch read 9.2-9.3 ms traced against 4.4 ms on
the host clock untraced, an FM push's 3.9-4.7 against 1.9 ms. A change
that cuts the number of eager ops lowers this metric by more than it
lowers the untraced push."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "push_launch_ms.stream", "push",
                                 "push.launch")
