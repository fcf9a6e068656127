"""push_upload_ms.stream: the raw chunks of a push onto the card, in ms a
push: the median over the window's ``push`` spans of the ``push.upload``
spans inside each, summed (moves push_ms_p50)."""

from benchmark.core import spans


def read(ctx):
    return spans.median_child_ms(ctx, "push_upload_ms.stream", "push",
                                 "push.upload")
