"""The batch feed of the host loops (``pipeline.run_capture``,
``wideband.run_wideband_capture``): host → card on one card, host → host
on the CPU and under a mesh.

A batch is one (bf + 2)-slot buffer a channel: slot s holds capture frame
start − 1 + s, so slots 1..count are the frames written and slots 0 and
count + 1 their CPI-overlap halo. ``plan_batches`` says which capture
frames [lo, hi) each buffer holds; every other slot is zero (the capture's
edges, past its end). Wideband CPIs do not overlap: their batches hold
only frames [start, start + count), with no halo and nothing reused.

Each frame is read from the reader once:

* **Halo kept.** Two staging buffers a channel (``CardFeed``), used in
  turn. Batch i + 1's slots 0 and 1 hold the frames of batch i's slots
  count and count + 1, so they are a copy from the other staging buffer
  (``Batch.reuse``), on the card where the buffers lie there; the host
  sends only the frames the buffers do not hold. The first batch of a
  call reads its left margin from the host. Zero slots are memsets.
* **Chunked staging on a copy stream** (``ChunkStager``), for buffers on
  the card; host buffers are written directly. The new frames'
  bytes go through a small ring of pinned chunk slots, each chunk copied
  to the card on a copy stream as soon as it lands in its slot; a slot is
  refilled only after its copy's event has completed. The compute stream
  waits for the batch's last chunk before the graph reads the buffer, and
  a buffer is rewritten only after the replay that read it (an event
  recorded after the replay).

A slot is filled on the loop's thread by torch's own copy, which splits a
chunk over its intra-op threads; more host threads, each filling slots of
their own, were slower on the card's host (PERF.md §6).

``stage_info()`` gives the counters of every feed since the process
started, as ``ops/graphs.cache_info()`` gives the graphs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import numpy as np
import torch

# measured on the card's host (PERF.md §6): torch's copy on the loop's
# thread, spread over its intra-op threads, into two 16 MiB slots
CHUNK_BYTES = 16 << 20      # a pinned slot
DEPTH = 2                   # slots in the ring

_totals: collections.Counter = collections.Counter()


def stage_info() -> dict:
    """The counters of every feed since the process started: ``calls``
    (one a host loop's call), ``batches``, ``frames_sent`` (from the
    reader's frames), ``frames_reused`` (halo slots copied from the other
    set: 2 a batch after a call's first), ``frames_zeroed`` (slots set to
    zero),
    ``bytes_sent``, ``chunks`` and ``slot_waits`` (the loop's thread found
    its next slot's copy to the card not yet done and waited for it)."""
    keys = ("calls", "batches", "frames_sent", "frames_reused",
            "frames_zeroed", "bytes_sent", "chunks", "slot_waits")
    return {k: _totals[k] for k in keys}


@dataclasses.dataclass(frozen=True)
class Batch:
    """One batch of the host loop: frames [start, start + count) written
    from buffer slots 1..count; the buffer holds capture frames [lo, hi)
    from slot ``lo - start + 1`` on, the first ``reuse`` of them kept on
    the card from the previous batch."""
    start: int
    count: int
    lo: int
    hi: int
    reuse: int = 0

    @property
    def first_slot(self) -> int:
        return self.lo - self.start + 1

    @property
    def read(self) -> tuple:
        """(first frame, frames) the host reads for this batch."""
        return self.lo + self.reuse, self.hi - self.lo - self.reuse


def plan_batches(total: int, bf: int, done: int, margin_lo: bool,
                 margin_hi: bool) -> list:
    """The batches of a run over frames [done, total) in batches of ``bf``.

    A batch's left halo is frame start − 1 when there is one (a resumed
    run, a sharded reader's ``margin_lo``), its right halo frame
    start + count when the capture holds it (``margin_hi``: the frame after
    ``total``). Every batch after the first takes its frames start − 1 and
    start, the previous batch's last two slots, from the other set of
    buffers."""
    batches = []
    while done < total:
        count = min(bf, total - done)
        lo = done - 1 if (done > 0 or margin_lo) else 0
        hi = min(total + (1 if margin_hi else 0), done + count + 1)
        batches.append(Batch(done, count, lo, hi, 2 if batches else 0))
        done += count
    return batches


def _host_bytes(src, frames: int, frame_bytes: int) -> torch.Tensor:
    """``src`` (``frames`` frames of ``frame_bytes`` bytes: int16 or float32
    IQ pairs, complex64) as a 1-D uint8 CPU tensor: a view of a contiguous
    array, else of a contiguous copy. A read-only array (a reader's
    ``np.frombuffer``) is only read, so torch's warning about it is not
    raised. Raises ValueError for a size that does not match."""
    a = np.asarray(src)
    if a.nbytes != frames * frame_bytes or (frames and a.shape[0] != frames):
        raise ValueError(f"expected {frames} frames of {frame_bytes} bytes, "
                         f"got an array of shape {a.shape} ({a.nbytes} "
                         "bytes)")
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    if flat.flags.writeable:
        return torch.from_numpy(flat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(flat)


class ChunkStager:
    """Host bytes into a tensor on ``device`` in chunks of ``CHUNK_BYTES``:
    on a card through a ring of ``DEPTH`` pinned slots, filled on the
    caller's thread, each chunk copied on the copy stream ``stream`` as
    soon as it lands; on the CPU straight into the target (the slots exist
    to make a copy to the card asynchronous), with no events."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.chunk_bytes = CHUNK_BYTES
        self.slots = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                  pin_memory=True)
                      for _ in range(DEPTH if self.cuda else 0)]
        self.events = [None] * DEPTH
        self.turn = 0
        self.counts = collections.Counter()

    def send(self, jobs) -> None:
        """Copy every (source, target) pair of ``jobs`` (1-D uint8 host
        tensors and target tensors of equal length). Returns once the last
        chunk's copy is enqueued on the copy stream."""
        for src, dst in jobs:
            if src.shape[0] != dst.shape[0]:
                raise ValueError(f"{src.shape[0]} source bytes for "
                                 f"{dst.shape[0]} target bytes")
        for src, dst in jobs:
            for at in range(0, src.shape[0], self.chunk_bytes):
                end = min(src.shape[0], at + self.chunk_bytes)
                if self.cuda:
                    k = self.turn
                    self.turn = (k + 1) % len(self.slots)
                    event = self.events[k]
                    if event is not None and not event.query():
                        self.counts["slot_waits"] += 1
                        event.synchronize()
                    slot = self.slots[k][:end - at]
                    slot.copy_(src[at:end])
                    with torch.cuda.stream(self.stream):
                        dst[at:end].copy_(slot, non_blocking=True)
                        self.events[k] = torch.cuda.Event()
                        self.events[k].record(self.stream)
                else:
                    dst[at:end].copy_(src[at:end])
                self.counts.update(chunks=1, bytes_sent=end - at)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a 1-D uint8 tensor (a view)."""
    return t.reshape(-1).view(torch.uint8)


class CardFeed:
    """The two channels' staging buffers of a host loop on ``device``:
    two sets of (slots, lc, 2) ``dtype`` buffers, used in turn, fed by a
    ``ChunkStager``; host buffers are pinned with ``pin`` (a mesh that
    copies them to its cards). ``stage`` fills one set for a batch and
    returns it; ``consumed`` marks it read by the work queued on the
    current stream since."""

    def __init__(self, slots: int, lc: int, dtype: torch.dtype,
                 device: torch.device, channels: int = 2, pin: bool = False):
        self.device = device
        self.sets = [[torch.empty((slots, lc, 2), dtype=dtype, device=device,
                                  pin_memory=pin)
                      for _ in range(channels)] for _ in range(2)]
        self.frame_bytes = lc * 2 * self.sets[0][0].element_size()
        self.stager = ChunkStager(device)
        self.used = [None, None]        # event: the set's last reader done
        self.turn = 0
        self.prev = None                # (set, count) of the previous batch
        self.counts = collections.Counter(calls=1)

    def stage(self, batch: Batch, raws) -> list:
        """Fill the next set for ``batch`` from ``raws`` (a channel each:
        the frames ``batch.read`` names, as the reader gives them) and
        return it. On the card the current stream waits for the set's
        copies; the host returns once the last chunk is enqueued."""
        k = self.turn
        bufs = self.sets[k]
        stream = self.stager.stream
        if stream is not None and self.used[k] is not None:
            stream.wait_event(self.used[k])
        first, held = batch.first_slot, batch.hi - batch.lo
        start, frames = first + batch.reuse, held - batch.reuse
        if batch.reuse and self.prev is None:
            raise ValueError("a batch reuses frames no previous batch "
                             "staged")
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            for c, buf in enumerate(bufs):
                if batch.reuse:
                    pk, pcount = self.prev
                    buf[first:start].copy_(
                        self.sets[pk][c][pcount:pcount + batch.reuse])
                buf[:first].zero_()
                buf[first + held:].zero_()
        self.stager.send([(_host_bytes(raw, frames, self.frame_bytes),
                            _bytes(buf[start:start + frames]))
                           for raw, buf in zip(raws, bufs)])
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
            torch.cuda.current_stream(self.device).wait_event(ready)
        self.counts.update(batches=1, frames_sent=frames * len(bufs),
                           frames_reused=batch.reuse * len(bufs),
                           frames_zeroed=(len(bufs[0]) - held) * len(bufs))
        self.prev = (k, batch.count)
        self.turn = 1 - k
        return bufs

    def consumed(self) -> None:
        """The set ``stage`` returned last is read by the work queued on the
        current stream so far: it is refilled only after that work."""
        if self.stager.stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.used[1 - self.turn] = event

    def close(self) -> None:
        """Add this feed's counters to ``stage_info()``."""
        _totals.update(self.counts)
        _totals.update(self.stager.counts)
        self.counts.clear()
        self.stager.counts.clear()
