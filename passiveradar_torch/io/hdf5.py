"""Chunked, prefetching capture reader (port of the JAX package's
io/hdf5.py).

The read pattern mirrors the reference's ingest (main.py:44-120): estimate
the inter-channel offset from the head of the capture, trim both channels
into alignment, then serve fixed-length frame chunks. A background thread
keeps the next batch's disk read in flight while the device computes.

Both reference capture layouts are supported (PRconfig.yaml:6-18):
separate per-channel datasets of interleaved IQ (float32 or int16; int16
ships raw and converts on the device), and the single 4-way interleaved
dataset [refI, refQ, srvI, srvQ, ...], de-multiplexed on the host.

The capture is an HDF5 file, read through io/writers.hdf5_backend() (h5py
when installed, else io/hdf5_min.py, which serves a contiguous dataset by
os.pread), or a zarr v2 directory store holding the same dataset paths as
arrays (``io/synthetic.write_synth_capture`` writes either, by the path's
``.zarr`` suffix).

The offset search runs inside the span ``capture.align`` (spans.py).
``read_info()`` gives what every prefetch reader's thread has read since
the process started, as ``feed.stage_info()`` gives the feeds. Where the
values delivered are the values stored (separate-channel datasets of an
HDF5 file, int16 shipped raw or float32 read as float32 or complex64),
the thread reads each batch straight into buffers that it reuses
(``CaptureReader.fill_frames``, one ``read_direct`` a channel).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time

import numpy as np

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.io.native import demux2, i16_to_f32
from passiveradar_torch.io.writers import hdf5_backend, zarr_backend
from passiveradar_torch.ops.xcorr import find_channel_offset
from passiveradar_torch.spans import span

_totals: collections.Counter = collections.Counter()
_totals_lock = threading.Lock()


def read_info() -> dict:
    """What every PrefetchReader's thread did since the process started:
    ``batches`` and ``bytes`` read, ``read_s`` (seconds inside the
    reader's read), ``put_wait_s`` (seconds blocked on a full queue),
    ``direct`` (batches read straight into a pooled buffer pair) and
    ``buffers`` (pooled buffer pairs allocated)."""
    with _totals_lock:
        return {k: _totals[k]
                for k in ("batches", "bytes", "read_s", "put_wait_s",
                          "direct", "buffers")}


def _count(**counts) -> None:
    with _totals_lock:
        _totals.update(counts)


class CaptureReader:
    """Aligned frame access to a two-channel capture.

    ``device`` is where the offset search runs (default: the CUDA card).
    """

    def __init__(self, cfg: RadarConfig, path: str | None = None,
                 estimate_offset: bool = True, max_offset_lags: int = 5_000_000,
                 int16_scale: float | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.path = path or cfg.input_file
        self.int16_scale = (cfg.int16_scale if int16_scale is None
                            else int16_scale)
        self._file = None
        if os.path.isdir(self.path):            # zarr v2 directory store
            zarr = zarr_backend()

            def dataset(key):
                return zarr.open(os.path.join(self.path, key.strip("/")),
                                 mode="r")
        else:
            self._file = hdf5_backend().File(self.path, "r")
            dataset = self._file.__getitem__
        self.interleaved = bool(cfg.interleaved_input_channels)
        if self.interleaved:
            self._data = dataset(cfg.interleaved_data_path)
        else:
            self._ref = dataset(cfg.input_ref_path)
            self._srv = dataset(cfg.input_srv_path)
        # separate-channel int16 captures ship raw int16 to the device,
        # which multiplies by cfg.int16_scale: only valid when this reader's
        # scale agrees with the config's
        self._ships_int16 = (not self.interleaved
                             and self._ref.dtype == np.int16
                             and self.int16_scale == cfg.int16_scale)
        self.offset = 0
        if estimate_offset:
            with span("capture.align"):
                self.offset = self._estimate_offset(max_offset_lags)
        self._apply_offset()

    def _to_f32(self, raw: np.ndarray) -> np.ndarray:
        if raw.dtype == np.int16:
            return i16_to_f32(raw, self.int16_scale)
        return np.asarray(raw, np.float32)

    def _estimate_offset(self, max_lags: int) -> int:
        """Offset from the capture head (reference main.py:50-54 / 79-83)."""
        if self.interleaved:
            head = min(20 * self.cfg.cpi_samples, len(self._data))
            refc, srvc = demux2(self._to_f32(np.asarray(self._data[:head])),
                                self.int16_scale)
        else:
            head = min(10 * self.cfg.cpi_samples, len(self._ref),
                       len(self._srv)) // 2 * 2
            refc = self._to_f32(np.asarray(self._ref[:head])).view(np.complex64)
            srvc = self._to_f32(np.asarray(self._srv[:head])).view(np.complex64)
        nl = min(max_lags, refc.shape[0] - 1)
        return int(find_channel_offset(refc, srvc, 1, nl, device=self.device))

    def _apply_offset(self):
        off = self.offset   # in complex channel samples
        if off > 0:
            self._ref_off, self._srv_off = off, 0
        else:
            self._ref_off, self._srv_off = 0, -off
        self.frame_len_c = self.cfg.input_chunk_length // 2
        self.frame_len = self.cfg.input_chunk_length
        if self.interleaved:
            usable = len(self._data) // 4 - abs(off)
        else:
            usable = min(len(self._ref), len(self._srv)) // 2 - abs(off)
        self.num_frames = usable // self.frame_len_c
        self._first_frame = 0

    def shard(self, process_index: int, process_count: int) -> "CaptureReader":
        """Restrict to this process's contiguous frame range (multi-process
        ingest). The last process takes the remainder frames.

        Interior shard edges allow one frame of margin reads into the
        neighbouring range (frame_margin_before/after), so CPI-overlap halos
        stay exact at process boundaries; frame_offset is the global index
        of local frame 0 (the mixing phases depend on the global frame
        number). Every read adds it."""
        per = self.num_frames // process_count
        self._first_frame = process_index * per
        if process_index == process_count - 1:
            self.num_frames -= per * (process_count - 1)
        else:
            self.num_frames = per
        self.frame_offset = self._first_frame
        self.frame_margin_before = process_index > 0
        self.frame_margin_after = process_index < process_count - 1
        return self

    def _channel_slices(self, start: int, count: int):
        """The two separate-channel datasets' slices of ``count`` frames
        from ``start`` (int16 or float32 values, two a complex sample)."""
        s_c = (self._first_frame + start) * self.frame_len_c
        e_c = s_c + count * self.frame_len_c
        return tuple(slice(2 * (s_c + off), 2 * (e_c + off))
                     for off in (self._ref_off, self._srv_off))

    def read_raw_frames(self, start: int, count: int):
        """(count, input_chunk_length) float32 interleaved IQ per channel."""
        if self.interleaved:
            ref, srv = self.read_iq_frames(start, count)
            return (ref.view(np.float32).reshape(count, self.frame_len),
                    srv.view(np.float32).reshape(count, self.frame_len))
        rs, ss = self._channel_slices(start, count)
        ref = self._to_f32(np.asarray(self._ref[rs]))
        srv = self._to_f32(np.asarray(self._srv[ss]))
        return (ref.reshape(count, self.frame_len),
                srv.reshape(count, self.frame_len))

    @property
    def pair_dtype(self):
        """dtype of read_pair_frames: int16 when the capture ships raw."""
        return np.int16 if self._ships_int16 else np.float32

    def read_pair_frames(self, start: int, count: int):
        """(count, frame_len_c, 2) IQ pairs in ``pair_dtype`` — the device
        dispatch format (raw int16 pairs for separate-channel int16
        captures, converted on the device)."""
        if not self._ships_int16:
            ref, srv = self.read_raw_frames(start, count)
            return (ref.reshape(count, self.frame_len_c, 2),
                    srv.reshape(count, self.frame_len_c, 2))
        rs, ss = self._channel_slices(start, count)
        return (np.asarray(self._ref[rs]).reshape(count, self.frame_len_c, 2),
                np.asarray(self._srv[ss]).reshape(count, self.frame_len_c, 2))

    def read_iq_frames(self, start: int, count: int):
        """(count, input_chunk_length//2) complex64 per channel."""
        if not self.interleaved:
            ref, srv = self.read_raw_frames(start, count)
            return ref.view(np.complex64), srv.view(np.complex64)
        s_c = (self._first_frame + start) * self.frame_len_c
        e_c = s_c + count * self.frame_len_c
        lo = s_c + min(self._ref_off, self._srv_off)
        hi = e_c + max(self._ref_off, self._srv_off)
        raw = np.asarray(self._data[4 * lo:4 * hi])
        ref, srv = demux2(raw if raw.dtype == np.int16
                          else np.asarray(raw, np.float32), self.int16_scale)
        r0 = s_c + self._ref_off - lo
        s0 = s_c + self._srv_off - lo
        n = count * self.frame_len_c
        return (ref[r0:r0 + n].reshape(count, self.frame_len_c),
                srv[s0:s0 + n].reshape(count, self.frame_len_c))

    def fill_layout(self, mode: str):
        """(frame shape, dtype) of the frames of ``read_pair_frames``
        ("pair") or ``read_iq_frames`` ("iq"), where ``fill_frames`` reads
        them straight into a caller's buffers; None where it cannot, and
        the caller reads with those: a zarr store, the 4-way interleaved
        layout, or stored values that the host converts."""
        want = np.dtype(self.pair_dtype if mode == "pair" else np.float32)
        if (self._file is None or self.interleaved
                or self._ref.dtype != want or self._srv.dtype != want):
            return None
        if mode == "pair":
            return (self.frame_len_c, 2), want
        return (self.frame_len_c,), np.dtype(np.complex64)

    def fill_frames(self, start: int, count: int, out) -> None:
        """The frames that ``read_pair_frames`` or ``read_iq_frames``
        return, written into ``out`` (a C-contiguous array a channel, of a
        layout ``fill_layout`` gives), by one ``read_direct`` a channel:
        straight into ``out``'s memory where the dataset is contiguous."""
        for ds, sl, dest in zip((self._ref, self._srv),
                                self._channel_slices(start, count), out):
            ds.read_direct(dest.reshape(-1).view(ds.dtype), sl)

    def close(self):
        if self._file is not None:
            self._file.close()


class PrefetchReader:
    """Wraps a CaptureReader with a one-batch-ahead background thread.

    Where the reader can fill a caller's buffers (its
    ``fill_layout(mode)`` is not None), the thread reads each batch into a
    pair of buffers taken from a pool that this reader keeps, each sized to
    the plan's largest read, and yields ``[:count]`` views of them: **a
    batch's arrays are valid until the next one is requested**, when the
    pair goes back to the pool. The thread allocates a pair only when none
    is free, so at most four: the consumer's, the queue's two and the one
    it fills. Other readers' arrays (a ring's views, a zarr store's,
    converted values) are yielded as the reader returns them.

    ``close()`` stops the thread (the caller's loop ended early or failed):
    no read starts after it, and the queue is drained so that a thread
    blocked on a full queue returns."""

    def __init__(self, reader: CaptureReader, batches, mode: str = "pair"):
        self.reader = reader
        self.num_frames = reader.num_frames
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._batches = list(batches)
        self._read = getattr(reader, {"iq": "read_iq_frames",
                                      "pair": "read_pair_frames"}[mode])
        layout = getattr(reader, "fill_layout", None)
        self._layout = (layout(mode) if layout is not None and self._batches
                        else None)
        self._free: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _pair(self) -> tuple:
        """A free buffer pair of the pool, or a new one."""
        try:
            return self._free.pop()
        except IndexError:
            shape, dtype = self._layout
            most = max(count for _, count in self._batches)
            _count(buffers=1)
            return tuple(np.empty((most, *shape), dtype) for _ in range(2))

    def _work(self):
        try:
            for start, count in self._batches:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                if self._layout is None:
                    pair, arrays = None, self._read(start, count)
                else:
                    pair = self._pair()
                    arrays = tuple(b[:count] for b in pair)
                    self.reader.fill_frames(start, count, arrays)
                t1 = time.perf_counter()
                _count(batches=1, bytes=sum(a.nbytes for a in arrays),
                       read_s=t1 - t0, direct=int(pair is not None))
                self._q.put((start, count, arrays, pair))
                _count(put_wait_s=time.perf_counter() - t1)
            self._q.put(None)
        except BaseException as e:  # hand the failure to the consumer
            self._q.put(e)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            start, count, arrays, pair = item
            yield start, count, arrays
            if pair is not None:        # the next batch is asked for
                self._free.append(pair)

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self) -> None:
        """Stop the thread and join it; what it read is dropped. After one
        drain the thread makes at most two more puts (a batch, then the end
        or its failure), which the queue of two holds."""
        self._stop.set()
        self._drain()
        self._thread.join()
        self._drain()
        self._free.clear()
