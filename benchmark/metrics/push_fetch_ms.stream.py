"""push_fetch_ms.stream: a push's results to the host, the wait for the
card included, in ms a push: the median over the window's ``push`` spans
of the ``push.fetch`` spans inside each, summed (moves push_ms_p50)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "push_fetch_ms.stream", "push",
                                 "push.fetch")
