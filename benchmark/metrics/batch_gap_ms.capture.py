"""batch_gap_ms.capture: the median idle gap, in ms, between the end of one
batch's device work and the start of the next batch's (its first large
host-to-device copy; core/trace.batch_starts): what the host loop of
``run_capture`` / ``run_wideband_capture`` leaves the card waiting between
batches (moves frames_per_s)."""

import bisect
import statistics

from benchmark.core import trace


def read(ctx):
    starts = trace.batch_starts(ctx.ops)
    if len(starts) < 2:
        ctx.note("batch_gap_ms.capture: fewer than two batch starts found "
                 "(no large host-to-device copy after a device-to-host one)")
        return None
    busy = trace.busy_intervals(ctx.ops)
    begins = [s for s, _ in busy]
    gaps = []
    for op in starts[1:]:
        i = bisect.bisect_right(begins, op.start) - 1
        # the gap ends where the batch's interval begins; 0 if the device
        # was still busy with the previous batch
        gaps.append((busy[i][0] - busy[i - 1][1]) * 1e-6
                    if i > 0 and busy[i][0] == op.start else 0.0)
    return statistics.median(gaps)
