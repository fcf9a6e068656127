"""align_ms.file: the offset search of a file capture, in ms a call: the
median over the window's ``capture.align`` spans (``io/hdf5.CaptureReader``:
the head of both channels read, converted and cross-correlated until the
offset is on the host); nothing where the trace holds no such span
(moves frames_per_s)."""

import statistics

from benchmark.core import spans


def read(ctx):
    found = spans.named(ctx.spans, "capture.align")
    if not found:
        ctx.note("align_ms.file: no capture.align span in the trace (a "
                 "program that records no such span)")
        return None
    return statistics.median((s.end - s.start) * 1e-6 for s in found)
