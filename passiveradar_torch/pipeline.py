"""The end-to-end processing pipeline on torch tensors.

Port of the JAX package's pipeline.py. Per batch of frames:

    raw per-frame chunks (int16 / float32 IQ pairs)
      → fused down-conversion + polyphase resample   (main.py:122-166;
        the CUDA kernel of ops/resample_kernel.py does the bulk)
      → clutter removal: multi-Doppler-bin LS         (main.py:168-176;
        its full-length FFTs on the CUDA kernel of ops/fft_kernel.py under
        PASSIVERADAR_PALLAS_FFT=1), or NLMS on the CUDA kernel of
        ops/nlms_kernel.py
      → 50% CPI-overlap halo                          (main.py:178-181)
      → windowed fast CAF → range-Doppler frames      (main.py:183-194)

``run_capture`` is the host loop: fixed bf+2-frame buffers with a one-frame
halo margin on each side, pinned host buffers, non-blocking copies both
ways, and one batch of device work in flight while the host writes the
previous batch's maps and the prefetch thread reads the next one from disk.
A batch runs on one device (``process_frames``) or split over the devices
of a frame mesh (``process_frames_shmap``: the halo is then an exchange
between shards). ``process_frames_groups`` runs G stacked batches a call.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.io.hdf5 import PrefetchReader
from passiveradar_torch.ops.caf import fast_xambg, resolve_window
from passiveradar_torch.ops.clutter_graph import ls_filter_multiple_graphed
from passiveradar_torch.ops.fir import mix_resample_poly_batch
from passiveradar_torch.ops.mixer import block_phase_offsets
from passiveradar_torch.ops.nlms_kernel import nlms_filter_batch
from passiveradar_torch.ops.util import deinterleave_batch
from passiveradar_torch.parallel.halo import local_overlap, overlap_frames, \
    split_frames


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


def _to_device(x, dev: torch.device) -> torch.Tensor:
    return _as_tensor(x).to(dev, non_blocking=True)


def _preprocess_impl(raw: torch.Tensor, phases: torch.Tensor,
                     cfg: RadarConfig) -> torch.Tensor:
    """Deinterleave → down-convert → resample one channel's frame batch.

    raw: (F, L//2, 2) float32 or int16 IQ pairs, (F, L//2) complex64, or
    (F, L) float32 interleaved IQ. Returns (F, output_chunk_length)
    complex64 at the IF rate.
    """
    if raw.dtype == torch.int16:
        # exact: every int16 is representable in float32
        raw = raw.float() * float(np.float32(cfg.int16_scale))
    iq = raw if (raw.is_complex() or raw.dim() == 3) else \
        deinterleave_batch(raw)
    resampled = mix_resample_poly_batch(iq, phases, cfg.offset_freq,
                                        cfg.input_sample_rate,
                                        cfg.resamp_up, cfg.resamp_dn,
                                        padtype="line")
    # per-chunk resample output may be ±1 sample off output_chunk_length
    out_len = cfg.output_chunk_length
    cur = resampled.shape[1]
    if cur < out_len:
        return torch.nn.functional.pad(resampled, (0, out_len - cur))
    return resampled[:, :out_len]


def _clutter_impl(ref: torch.Tensor, srv: torch.Tensor,
                  cfg: RadarConfig) -> torch.Tensor:
    """Clutter cancellation over a frame batch.

    cfg.clutter_method selects the canceller: 'ls_multiple' (the reference
    pipeline's sequential multi-Doppler-bin Toeplitz LS, main.py:168-176),
    'nlms' (NLMS with the JAX scan's plain division: an all-zero window,
    such as a zero margin frame, gives a NaN frame), 'nlms_pallas' (NLMS
    with the JAX Pallas kernel's guard: an all-zero window leaves the taps
    unchanged), or 'none'. Both NLMS methods run the whole batch in one
    launch of the NLMS kernel; on the card the LS stage is a replayed CUDA
    graph (ops/clutter_graph.py), one a device and batch shape.
    """
    method = cfg.clutter_method
    if method == "none":
        return srv
    if method in ("nlms", "nlms_pallas"):
        return nlms_filter_batch(
            ref, srv, cfg.num_range_cells, cfg.nlms_mu,
            zero_window="nan" if method == "nlms" else "zero")
    if method != "ls_multiple":
        raise ValueError(f"unknown clutter_method {method!r}")
    return ls_filter_multiple_graphed(
        ref, srv, cfg.num_range_cells, cfg.IF_sample_rate,
        cfg.clutter_doppler_bins, impl=cfg.clutter_impl,
        solver=cfg.clutter_solver)


@functools.lru_cache(maxsize=8)
def _window_tensor(spec, n: int, device: torch.device):
    win = resolve_window(spec, n)
    return None if win is None else torch.from_numpy(win).to(device)


def _caf_windowed(ref_ov: torch.Tensor, srv_ov: torch.Tensor,
                  cfg: RadarConfig) -> torch.Tensor:
    """Windowed CAF of already halo-extended frames →
    (F, num_doppler_cells, num_range_cells+1) complex64 maps."""
    win = _window_tensor(cfg.caf_window, cfg.caf_input_samples,
                         ref_ov.device)
    return fast_xambg(ref_ov, srv_ov, cfg.num_range_cells,
                      cfg.num_doppler_cells, window=win,
                      short_filt=cfg.caf_short_filt)


def _caf_batch_impl(ref: torch.Tensor, srv_clean: torch.Tensor,
                    cfg: RadarConfig) -> torch.Tensor:
    """Halo overlap + windowed CAF: (F, output_chunk_length) pairs →
    (F, num_doppler_cells, num_range_cells+1) complex64 maps."""
    if cfg.window_overlap:
        ref = overlap_frames(ref, cfg.window_overlap)
        srv_clean = overlap_frames(srv_clean, cfg.window_overlap)
    return _caf_windowed(ref, srv_clean, cfg)


def _process_frames_impl(raw_ref: torch.Tensor, raw_srv: torch.Tensor,
                         phases: torch.Tensor,
                         cfg: RadarConfig) -> torch.Tensor:
    ref = _preprocess_impl(raw_ref, phases, cfg)
    srv = _preprocess_impl(raw_srv, phases, cfg)
    return _caf_batch_impl(ref, _clutter_impl(ref, srv, cfg), cfg)


def preprocess_batch(raw, phases, cfg: RadarConfig, device=None):
    """Preprocess one channel's frame batch on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return _preprocess_impl(_to_device(raw, dev), _to_device(phases, dev),
                            cfg)


def clutter_batch(ref, srv, cfg: RadarConfig, device=None) -> torch.Tensor:
    """Clutter-cancel one preprocessed frame batch on ``device`` (default
    CUDA): (F, output_chunk_length) complex64 ref and srv → cleaned srv."""
    dev = resolve_device(device)
    return _clutter_impl(_to_device(ref, dev), _to_device(srv, dev), cfg)


def caf_batch(ref, srv_clean, cfg: RadarConfig, device=None) -> torch.Tensor:
    """Halo overlap + windowed CAF of one preprocessed, clutter-cancelled
    frame batch on ``device`` (default CUDA): (F, output_chunk_length)
    complex64 ref and srv_clean → (F, num_doppler_cells,
    num_range_cells+1) complex64 range-Doppler frames."""
    dev = resolve_device(device)
    return _caf_batch_impl(_to_device(ref, dev), _to_device(srv_clean, dev),
                           cfg)


def process_frames(raw_ref, raw_srv, phases, cfg: RadarConfig,
                   device=None) -> torch.Tensor:
    """Full chain for a self-contained batch of frames (halo from within the
    batch, zero at its edges). raw_*: (F, input_chunk_length) float32 or
    (F, input_chunk_length//2, 2) IQ pairs; phases: (F,) float32. Returns
    (F, num_doppler_cells, num_range_cells+1) complex64 on ``device``."""
    dev = resolve_device(device)
    return _process_frames_impl(_to_device(raw_ref, dev),
                                _to_device(raw_srv, dev),
                                _to_device(phases, dev), cfg)


def _process_groups_impl(raw_refs: torch.Tensor, raw_srvs: torch.Tensor,
                         phases: torch.Tensor,
                         cfg: RadarConfig) -> torch.Tensor:
    return torch.stack([_process_frames_impl(r, s, p, cfg)
                        for r, s, p in zip(raw_refs, raw_srvs, phases)])


def process_frames_groups(raw_refs, raw_srvs, phases, cfg: RadarConfig,
                          device=None) -> torch.Tensor:
    """process_frames over G stacked batches in one call: raw_* (G, F, ...)
    and phases (G, F), each batch self-contained halo-wise exactly as G
    separate process_frames calls. Returns (G, F, num_doppler_cells,
    num_range_cells+1) complex64 on ``device`` (default CUDA).

    Where the JAX package scans the G batches inside one compiled program
    to pay its launch overhead once, eager PyTorch launches every batch's
    kernels anyway: this is a loop over the G batches."""
    dev = resolve_device(device)
    return _process_groups_impl(_to_device(raw_refs, dev),
                                _to_device(raw_srvs, dev),
                                _to_device(phases, dev), cfg)


def process_frames_shmap(raw_ref, raw_srv, phases, cfg: RadarConfig,
                         mesh) -> list:
    """The frame batch split over ``mesh`` (parallel/mesh.FrameMesh).

    The frame axis is cut into ``len(mesh)`` contiguous blocks, block i on
    ``mesh.devices[i]``; each block is preprocessed and clutter-cancelled
    on its device, the CPI-overlap halo is exchanged between neighbouring
    blocks (parallel/halo.local_overlap: the only traffic between shards),
    and each block's CAF runs on its device. raw_*, phases as for
    process_frames (numpy or tensors on any device); the frame count must
    divide the mesh. Returns the per-shard (F/len(mesh), num_doppler_cells,
    num_range_cells+1) complex64 map blocks in frame order, each on its
    shard's device; their concatenation equals process_frames."""
    refs, srvs, phs = (split_frames(_as_tensor(x), mesh)
                       for x in (raw_ref, raw_srv, phases))
    ref_blocks, clean_blocks = [], []
    for r, s, p in zip(refs, srvs, phs):
        ref = _preprocess_impl(r, p, cfg)
        ref_blocks.append(ref)
        clean_blocks.append(_clutter_impl(ref, _preprocess_impl(s, p, cfg),
                                          cfg))
    if cfg.window_overlap:
        ref_blocks = local_overlap(ref_blocks, cfg.window_overlap)
        clean_blocks = local_overlap(clean_blocks, cfg.window_overlap)
    return [_caf_windowed(r, s, cfg)
            for r, s in zip(ref_blocks, clean_blocks)]


def frame_phases(cfg: RadarConfig, frame_indices: Sequence[int]) -> np.ndarray:
    """Mixing phases for a set of global frame indices (main.py:125-130)."""
    n = int(np.max(frame_indices)) + 1 if len(frame_indices) else 0
    all_phases = block_phase_offsets(
        n, cfg.input_chunk_length // 2, cfg.offset_freq,
        cfg.input_sample_rate)
    return all_phases[np.asarray(frame_indices, dtype=np.int64)]


def capture_frame_count(reader, cfg: RadarConfig) -> int:
    """Frames a run over ``reader`` will produce: min(capture frames,
    cfg.num_frames), minus one under cfg.strict_frame_parity (the
    reference's final-chunk trim, main.py:116-120)."""
    total = min(reader.num_frames, cfg.num_frames)
    if cfg.strict_frame_parity and total > 0:
        total -= 1
    return total


def run_capture(reader, writer, cfg: RadarConfig,
                batch_frames: int | None = None, progress: bool = True,
                device=None, dispatch_groups: int = 1, mesh=None) -> int:
    """Host loop: stream a capture through the device pipeline in batches.

    reader: io.hdf5.CaptureReader-like (``num_frames``, ``read_pair_frames``
    or ``read_iq_frames``); writer: io.writers.MapWriter-like
    (``write(frames, start)``, ``frames_done``). Every batch is one fixed
    buffer of bf+2 frames whose slots 1..count hold the frames written; the
    extra slots carry the neighbouring frames (zero at the capture edges and
    past the end) so the CPI-overlap halo at batch boundaries is exact.
    Resume skips the frames the writer already holds. Returns the frame
    count of the run.

    A sharded reader (``CaptureReader.shard``) reads one margin frame into
    each neighbouring process's range and takes its mixing phases from the
    global frame index (``frame_offset``). ``mesh``
    (parallel/mesh.FrameMesh) splits each batch over its devices
    (process_frames_shmap), the buffer rounded up to a multiple of its
    size; ``device`` is then ignored. ``dispatch_groups`` (>= 1) is taken
    for the JAX package's signature and ignored: eager PyTorch launches
    every batch's kernels whether or not G batches share a call, so a
    grouped dispatch saves no launch and only delays the first batch's
    copy and write (process_frames_groups is the grouped call as a
    library function).
    """
    if int(dispatch_groups) < 1:
        raise ValueError(
            f"dispatch_groups must be >= 1, got {dispatch_groups}")
    total = capture_frame_count(reader, cfg)
    bf = batch_frames or cfg.frame_batch

    # the frame after the last one written is read as the right margin
    # when the capture holds it; under strict_frame_parity the reference
    # trims to N-1 frames first and overlaps with boundary=0
    # (main.py:116-120 then 180-181), so the last frame's right halo is
    # zero. A sharded reader's interior edges read into the neighbour's
    # range.
    margin_lo = bool(getattr(reader, "frame_margin_before", False))
    margin_hi = bool(getattr(reader, "frame_margin_after", False)) or (
        total < reader.num_frames and not cfg.strict_frame_parity)
    frame0 = int(getattr(reader, "frame_offset", 0))

    batches = []
    done = getattr(writer, "frames_done", 0)
    while done < total:
        count = min(bf, total - done)
        lo = done - 1 if (done > 0 or margin_lo) else 0
        hi = min(total + (1 if margin_hi else 0), done + count + 1)
        batches.append((done, count, lo, hi))
        done += count

    pair_mode = hasattr(reader, "read_pair_frames")
    pdt = reader.pair_dtype if pair_mode else np.float32
    prefetch = PrefetchReader(reader, [(lo, hi - lo) for _, _, lo, hi in batches],
                              mode="pair" if pair_mode else "iq")

    lc = cfg.input_chunk_length // 2
    buf_n = bf + 2
    if mesh is not None:
        devs = tuple(mesh.devices)
        buf_n = -(-buf_n // len(mesh)) * len(mesh)
    else:
        dev = resolve_device(device)
        devs = (dev,)
    pin = any(d.type == "cuda" for d in devs)
    tdt = torch.int16 if pdt == np.int16 else torch.float32
    map_shape = (buf_n, cfg.num_doppler_cells, cfg.num_range_cells + 1)
    # two sets of host buffers, used in turn: set s is refilled two batches
    # after its copies were queued, by when finish() has waited on them
    host = [dict(ref=torch.empty((buf_n, lc, 2), dtype=tdt, pin_memory=pin),
                 srv=torch.empty((buf_n, lc, 2), dtype=tdt, pin_memory=pin),
                 out=torch.empty(map_shape, dtype=torch.complex64,
                                 pin_memory=pin))
            for _ in range(2)]
    done = getattr(writer, "frames_done", 0)

    def dispatch(bufs, phases):
        """One batch's maps as (buf_n, ...) on the host, with the events
        to wait for before reading them."""
        ph = torch.from_numpy(phases)
        if mesh is not None:
            blocks = process_frames_shmap(bufs["ref"], bufs["srv"], ph, cfg,
                                          mesh)
        else:
            blocks = [_process_frames_impl(
                bufs["ref"].to(dev, non_blocking=True),
                bufs["srv"].to(dev, non_blocking=True), ph.to(dev), cfg)]
        if not pin:
            return torch.cat(blocks), []
        events, at = [], 0
        for b in blocks:
            bufs["out"][at:at + b.shape[0]].copy_(b, non_blocking=True)
            at += b.shape[0]
            if b.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(b.device))
                events.append(event)
        return bufs["out"], events

    def finish(item):
        nonlocal done
        start, count, maps, events = item
        for event in events:
            event.synchronize()
        writer.write(maps[1:1 + count].numpy(), start)
        done += count
        if progress:
            print(f"\r  processed {done}/{total} frames", end="", flush=True)

    pending = None
    for i, ((start, count, lo, hi), (_, _, (ref_raw, srv_raw))) in enumerate(
            zip(batches, prefetch)):
        bufs = host[i % 2]
        slot0 = 1 - (start - lo)
        nread = hi - lo
        for key, raw in (("ref", ref_raw), ("srv", srv_raw)):
            buf = bufs[key].numpy()
            buf[:slot0] = 0
            buf[slot0 + nread:] = 0
            buf[slot0:slot0 + nread] = raw if pair_mode else \
                raw.view(np.float32).reshape(nread, lc, 2)
        phases = np.zeros(buf_n, np.float32)
        phases[slot0:slot0 + nread] = frame_phases(
            cfg, list(range(frame0 + lo, frame0 + hi)))
        maps, events = dispatch(bufs, phases)
        if pending is not None:
            finish(pending)
        pending = (start, count, maps, events)
    if pending is not None:
        finish(pending)
    if progress:
        print()
    return total
