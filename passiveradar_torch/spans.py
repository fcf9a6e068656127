"""Named host spans at the port's layer boundaries, recorded into the
running ``torch.profiler``.

``with span("capture.stage"): ...`` records an event of that name on the
profiler's own clock, the clock of its device trace, so a span lines up
with the kernels and copies it waited for or enqueued. With no profiler
running a span costs one check of the profiler's flag and records
nothing. The spans are kept by the profiler and written out with its
trace (``cli.process --profile``, ``cli.stream --profile``, or any
``torch.profiler.profile`` around the call); there is no other recorder.

A span is recorded on the thread that enters it, and only on the thread
that started the profiler: the prefetch reader's thread is not seen.
``io/hdf5.read_info()`` counts what that thread does instead, since the
process started (read it twice and take the difference): ``batches`` and
``bytes`` read, ``read_s``, the seconds spent inside the reader's read
(for a file, the disk or page-cache read and the copies into the arrays
handed over), and ``put_wait_s``, the seconds it was blocked on a full
queue because the loop had not yet taken the batches before.

The spans, each with its parent:

* ``capture.align``: the offset search of ``io/hdf5.CaptureReader``
  when it opens a capture: the head of both channels read, converted on
  the host and cross-correlated (``ops/xcorr.find_channel_offset``) until
  the offset is on the host. Entered on the caller's thread, before the
  host loop's spans.
* ``capture.open``: what a call of ``pipeline.run_capture`` or
  ``wideband.run_wideband_capture`` does before its first batch (the
  batches planned, the prefetch reader started, the host buffers made;
  wideband: the writers opened).
* ``capture.batch``: one iteration of the loop of either, with the
  disjoint children
  ``capture.read`` (waiting on the prefetch reader), ``capture.stage`` (the
  host copies into the buffers the card reads; the FM loop on one card:
  from handing the batch to its feed until the last chunk's copy is
  enqueued, feed.py), ``capture.launch``
  (enqueuing the batch's device work), ``capture.wait`` (blocked until a
  batch's maps are on the host) and ``capture.write`` (the writers). In the
  FM loop the wait and the write are the previous batch's.
* ``push``: one call of a streaming processor's ``push``, ``flush`` or
  ``fetch_maps``, with the disjoint children ``push.upload`` (the raw
  chunks onto the device), ``push.launch`` (enqueuing the graphs, the
  channelizer and the tracker step) and ``push.fetch`` (the results to the
  host, the wait for the device included).
* ``graph.capture/<kind>``: a graph's warm-up and capture
  (``ops/graphs.capture``), within whatever span called it.

The events are the profiler's function-scope events, not its user
annotations: a user annotation also puts a span on the device's timeline
over every kernel launched inside it, which a reader of the device trace
would count as device work.
"""

from __future__ import annotations

import contextlib

import torch

# the C-level flag that torch.profiler sets while it records
_enabled = torch._C._autograd._profiler_enabled
# what a span records while the profiler runs: its name on entry and exit
_Record = torch._C._profiler._RecordFunctionFast

# what a span is while the profiler is off: nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` from entry to exit while a
    profiler runs, and does nothing otherwise."""
    if not _enabled():
        return _OFF
    return _Record(name)

