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

On the card every entry point (``preprocess_batch``, ``caf_batch``,
``process_frames``, ``process_frames_groups``, each shard of
``process_frames_shmap``) replays a CUDA graph of its eager chain, one a
key (ops/graphs.graphed): the counterparts of the JAX package's
``_preprocess_jit``, ``_caf_jit``, ``_process_frames_jit`` and
``_process_frames_groups_jit``. ``clutter_batch`` replays the LS stage's
graph (ops/clutter.ls_filter_multiple_graphed), which a graph being built
holds as eager launches. CPU tensors run the eager chain.

``run_capture`` is the host loop: fixed bf+2-frame buffers with a one-frame
halo margin on each side, and one batch of device work in flight while the
host writes the previous batch's maps and the prefetch thread reads the
next one from disk. Every batch is assembled by feed.py: each frame is
read once, a batch's halo is the previous batch's last two slots, kept
where the buffers lie. On one card the buffers lie there (the new frames
streamed in chunks on a copy stream into staging buffers that feed the
batch graph's static inputs; the maps come out of its static output into
pinned buffers without waiting); on the CPU and under a mesh they are host
tensors. A batch runs on one device (``process_frames``) or split over the
devices of a frame mesh (``process_frames_shmap``: the halo is then an
exchange between shards).
``process_frames_groups`` runs G stacked batches a call.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.feed import CardFeed, plan_batches
from passiveradar_torch.io.hdf5 import PrefetchReader
from passiveradar_torch.ops import graphs, nlms_kernel
from passiveradar_torch.ops.caf import device_window, fast_xambg
from passiveradar_torch.ops.clutter import ls_filter_multiple_graphed
from passiveradar_torch.ops.fir import mix_resample_poly_batch
from passiveradar_torch.ops.mixer import block_phase_offsets
from passiveradar_torch.ops.util import deinterleave_batch
from passiveradar_torch.parallel.halo import exchange_edges, \
    overlap_frames, split_frames, with_halo
from passiveradar_torch.spans import span


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
    launch of the NLMS kernel. On the card the LS stage is its own replayed
    CUDA graph (ops/clutter.ls_filter_multiple_graphed), except inside a
    graph being built, which holds the eager stage's launches.
    """
    method = cfg.clutter_method
    if method == "none":
        return srv
    if method in ("nlms", "nlms_pallas"):
        # looked up at call time: the key of a batch graph holds it
        return nlms_kernel.nlms_filter_batch(
            ref, srv, cfg.num_range_cells, cfg.nlms_mu,
            zero_window="nan" if method == "nlms" else "zero")
    if method != "ls_multiple":
        raise ValueError(f"unknown clutter_method {method!r}")
    return ls_filter_multiple_graphed(
        ref, srv, cfg.num_range_cells, cfg.IF_sample_rate,
        cfg.clutter_doppler_bins, impl=cfg.clutter_impl,
        solver=cfg.clutter_solver)


def _clean_impl(raw_ref: torch.Tensor, raw_srv: torch.Tensor,
                phases: torch.Tensor, cfg: RadarConfig) -> tuple:
    """Both channels' preprocess and the clutter stage: (ref, srv_clean),
    each (F, output_chunk_length) complex64."""
    ref = _preprocess_impl(raw_ref, phases, cfg)
    srv = _preprocess_impl(raw_srv, phases, cfg)
    return ref, _clutter_impl(ref, srv, cfg)


def _caf_windowed(ref_ov: torch.Tensor, srv_ov: torch.Tensor,
                  cfg: RadarConfig) -> torch.Tensor:
    """Windowed CAF of already halo-extended frames →
    (F, num_doppler_cells, num_range_cells+1) complex64 maps."""
    win = device_window(cfg.caf_window, cfg.caf_input_samples, ref_ov.device)
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


def _halo_caf_impl(ref: torch.Tensor, srv_clean: torch.Tensor,
                   ref_left: torch.Tensor, ref_right: torch.Tensor,
                   srv_left: torch.Tensor, srv_right: torch.Tensor,
                   cfg: RadarConfig) -> torch.Tensor:
    """One shard's CAF: its (f_local, output_chunk_length) blocks extended
    by the (1, window_overlap) halos its neighbours sent
    (parallel/halo.exchange_edges)."""
    return _caf_windowed(with_halo(ref, ref_left, ref_right),
                         with_halo(srv_clean, srv_left, srv_right), cfg)


def _process_frames_impl(raw_ref: torch.Tensor, raw_srv: torch.Tensor,
                         phases: torch.Tensor,
                         cfg: RadarConfig) -> torch.Tensor:
    """The eager chain of a batch (the LS stage its own graph on the card,
    outside a graph being built)."""
    return _caf_batch_impl(*_clean_impl(raw_ref, raw_srv, phases, cfg), cfg)


def _process_groups_impl(raw_refs: torch.Tensor, raw_srvs: torch.Tensor,
                         phases: torch.Tensor,
                         cfg: RadarConfig) -> torch.Tensor:
    return torch.stack([_process_frames_impl(r, s, p, cfg)
                        for r, s, p in zip(raw_refs, raw_srvs, phases)])


# ---- the entry points' CUDA graphs (ops/graphs.py) ---------------------------
# kind → the eager function a graph of that kind captures
_RUNS = dict(
    preprocess=_preprocess_impl,
    caf=_caf_batch_impl,
    clean=_clean_impl,
    frames=_process_frames_impl,
    groups=_process_groups_impl,
    halo_caf=_halo_caf_impl)


def _graphed(kind: str, inputs: tuple, cfg: RadarConfig, **kw):
    """The entry point ``kind`` of ``_RUNS`` through graphs.graphed, keyed
    by the whole config."""
    return graphs.graphed(
        kind, functools.partial(_RUNS[kind], cfg=cfg), inputs, cfg, info=dict(
            clutter_method=cfg.clutter_method, clutter_impl=cfg.clutter_impl,
            clutter_solver=cfg.clutter_solver,
            caf_short_filt=cfg.caf_short_filt), **kw)


def preprocess_batch(raw, phases, cfg: RadarConfig, device=None):
    """Preprocess one channel's frame batch on ``device`` (default CUDA; a
    replayed CUDA graph there)."""
    dev = resolve_device(device)
    return _graphed("preprocess", (_to_device(raw, dev),
                                   _to_device(phases, dev)), cfg)


def clutter_batch(ref, srv, cfg: RadarConfig, device=None) -> torch.Tensor:
    """Clutter-cancel one preprocessed frame batch on ``device`` (default
    CUDA): (F, output_chunk_length) complex64 ref and srv → cleaned srv.
    The LS stage is a replayed CUDA graph there
    (ops/clutter.ls_filter_multiple_graphed)."""
    dev = resolve_device(device)
    return _clutter_impl(_to_device(ref, dev), _to_device(srv, dev), cfg)


def _clean_batch(raw_ref, raw_srv, phases, cfg: RadarConfig,
                 device=None) -> tuple:
    """Both channels' preprocess and the clutter stage in one graph on
    ``device`` (default CUDA): (ref, srv_clean), as preprocess_batch twice
    and clutter_batch once return them (the stream's clean step)."""
    dev = resolve_device(device)
    return _graphed("clean", (_to_device(raw_ref, dev),
                              _to_device(raw_srv, dev),
                              _to_device(phases, dev)), cfg)


def caf_batch(ref, srv_clean, cfg: RadarConfig, device=None) -> torch.Tensor:
    """Halo overlap + windowed CAF of one preprocessed, clutter-cancelled
    frame batch on ``device`` (default CUDA; a replayed CUDA graph there):
    (F, output_chunk_length) complex64 ref and srv_clean → (F,
    num_doppler_cells, num_range_cells+1) complex64 range-Doppler
    frames."""
    dev = resolve_device(device)
    return _graphed("caf", (_to_device(ref, dev), _to_device(srv_clean, dev)),
                    cfg)


def process_frames(raw_ref, raw_srv, phases, cfg: RadarConfig,
                   device=None) -> torch.Tensor:
    """Full chain for a self-contained batch of frames (halo from within the
    batch, zero at its edges). raw_*: (F, input_chunk_length) float32 or
    (F, input_chunk_length//2, 2) IQ pairs; phases: (F,) float32. Returns
    (F, num_doppler_cells, num_range_cells+1) complex64 on ``device``.

    On the card the whole batch (both preprocesses, the clutter stage, the
    halo and the CAF) is one replayed CUDA graph a key (graphs.graph_key),
    the counterpart of the JAX package's one compiled program
    (``_process_frames_jit``); a key's first call runs the eager chain."""
    dev = resolve_device(device)
    return _graphed("frames", (_to_device(raw_ref, dev),
                               _to_device(raw_srv, dev),
                               _to_device(phases, dev)), cfg)


def process_frames_groups(raw_refs, raw_srvs, phases, cfg: RadarConfig,
                          device=None) -> torch.Tensor:
    """process_frames over G stacked batches in one call: raw_* (G, F, ...)
    and phases (G, F), each batch self-contained halo-wise exactly as G
    separate process_frames calls. Returns (G, F, num_doppler_cells,
    num_range_cells+1) complex64 on ``device`` (default CUDA).

    As the JAX package scans the G batches inside one compiled program, the
    card replays the G batches as one CUDA graph."""
    dev = resolve_device(device)
    return _graphed("groups", (_to_device(raw_refs, dev),
                               _to_device(raw_srvs, dev),
                               _to_device(phases, dev)), cfg)


def process_frames_shmap(raw_ref, raw_srv, phases, cfg: RadarConfig,
                         mesh) -> list:
    """The frame batch split over ``mesh`` (parallel/mesh.FrameMesh).

    The frame axis is cut into ``len(mesh)`` contiguous blocks, block i on
    ``mesh.devices[i]``; each block is preprocessed and clutter-cancelled
    on its device (one replayed graph on a card), the CPI-overlap halo is
    exchanged between neighbouring blocks (parallel/halo.exchange_edges:
    the only traffic between shards), and each block's overlap and CAF run
    on its device (a second graph). raw_*, phases as for process_frames
    (numpy or tensors on any device); the frame count must divide the mesh.
    Returns the per-shard (F/len(mesh), num_doppler_cells,
    num_range_cells+1) complex64 map blocks in frame order, each on its
    shard's device; their concatenation equals process_frames."""
    refs, srvs, phs = (split_frames(_as_tensor(x), mesh)
                       for x in (raw_ref, raw_srv, phases))
    cleaned = [_graphed("clean", (r, s, p), cfg)
               for r, s, p in zip(refs, srvs, phs)]
    ref_blocks = [r for r, _ in cleaned]
    clean_blocks = [s for _, s in cleaned]
    if not cfg.window_overlap:
        return [_graphed("caf", (r, s), cfg)
                for r, s in zip(ref_blocks, clean_blocks)]
    ref_edges = exchange_edges(ref_blocks, cfg.window_overlap)
    srv_edges = exchange_edges(clean_blocks, cfg.window_overlap)
    return [_graphed("halo_caf", (r, s, *re, *se), cfg)
            for r, s, re, se in zip(ref_blocks, clean_blocks, ref_edges,
                                    srv_edges)]


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


def capture_batches(reader, writer, cfg: RadarConfig, bf: int) -> tuple:
    """(frames of the run, its batches: feed.plan_batches) for a run of
    ``run_capture`` over ``reader`` into ``writer`` in batches of ``bf``.

    The frame after the last one written is read as the right margin when
    the capture holds it; under strict_frame_parity the reference trims to
    N-1 frames first and overlaps with boundary=0 (main.py:116-120 then
    180-181), so the last frame's right halo is zero. A sharded reader's
    interior edges read into the neighbour's range."""
    total = capture_frame_count(reader, cfg)
    margin_lo = bool(getattr(reader, "frame_margin_before", False))
    margin_hi = bool(getattr(reader, "frame_margin_after", False)) or (
        total < reader.num_frames and not cfg.strict_frame_parity)
    return total, plan_batches(total, bf, getattr(writer, "frames_done", 0),
                               margin_lo, margin_hi)


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
    size; ``device`` is then ignored. On one card each batch is a replay
    of the batch graph (process_frames). Every batch is assembled by a
    feed.CardFeed: each frame is read once, a batch's left halo is the
    previous batch's last two slots, copied where the buffers lie (on the
    card for one card; in host memory on the CPU and under a mesh, pinned
    where the mesh holds a card); ``feed.stage_info()`` counts what it
    sent and reused.
    ``dispatch_groups`` (>= 1) is taken for the JAX package's signature and
    ignored: a batch is already one graph launch, so a grouped dispatch
    would only delay the first batch's copy and write
    (process_frames_groups is the grouped call as a library function).
    """
    if int(dispatch_groups) < 1:
        raise ValueError(
            f"dispatch_groups must be >= 1, got {dispatch_groups}")
    with span("capture.open"):
        bf = batch_frames or cfg.frame_batch
        lc = cfg.input_chunk_length // 2
        buf_n = bf + 2
        if mesh is not None:
            devs = tuple(mesh.devices)
            buf_n = -(-buf_n // len(mesh)) * len(mesh)
        else:
            dev = resolve_device(device)
            devs = (dev,)
        pin = any(d.type == "cuda" for d in devs)
        total, batches = capture_batches(reader, writer, cfg, bf)
        frame0 = int(getattr(reader, "frame_offset", 0))

        pair_mode = hasattr(reader, "read_pair_frames")
        pdt = reader.pair_dtype if pair_mode else np.float32
        prefetch = PrefetchReader(reader, [b.read for b in batches],
                                  mode="pair" if pair_mode else "iq")

        tdt = torch.int16 if pdt == np.int16 else torch.float32
        map_shape = (buf_n, cfg.num_doppler_cells, cfg.num_range_cells + 1)
        # two sets of host buffers (and of the feed's), used in turn: set s
        # is refilled two batches after its copies were queued, by when
        # finish() has waited on them
        host = [dict(ph=torch.empty(buf_n, dtype=torch.float32,
                                    pin_memory=pin),
                     out=torch.empty(map_shape, dtype=torch.complex64,
                                     pin_memory=pin))
                for _ in range(2)]
        # on one card the frames stream to the card; on the CPU and under
        # a mesh the feed's buffers are host tensors
        feed = CardFeed(buf_n, lc, tdt,
                        dev if mesh is None else torch.device("cpu"),
                        pin=pin and mesh is not None)
    done = getattr(writer, "frames_done", 0)

    def dispatch(inputs, bufs):
        """One batch's maps as (buf_n, ...) on the host, with the events
        to wait for before reading them. On one card the feed's staging
        buffers go into the batch graph's static inputs and its static
        output straight into the pinned ``out``, all in stream order: the
        host never waits here, so the next batch is read and enqueued while
        the card works."""
        if mesh is not None:
            blocks = process_frames_shmap(*inputs, cfg, mesh)
        elif pin:
            blocks = [_graphed("frames", inputs, cfg, device=dev,
                               fresh=False)]
            feed.consumed()
        else:
            blocks = [_process_frames_impl(*inputs, cfg)]
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
        with span("capture.wait"):
            for event in events:
                event.synchronize()
        with span("capture.write"):
            writer.write(maps[1:1 + count].numpy(), start)
            done += count
            if progress:
                print(f"\r  processed {done}/{total} frames", end="",
                      flush=True)

    pending = None
    reads = iter(prefetch)
    try:
        for i, b in enumerate(batches):
            with span("capture.batch"):
                with span("capture.read"):
                    _, _, raws = next(reads)
                with span("capture.stage"):
                    bufs = host[i % 2]
                    slot0, held = b.first_slot, b.hi - b.lo
                    phases = bufs["ph"].numpy()
                    phases[:] = 0
                    phases[slot0:slot0 + held] = frame_phases(
                        cfg, list(range(frame0 + b.lo, frame0 + b.hi)))
                    staged = feed.stage(b, raws)
                with span("capture.launch"):
                    maps, events = dispatch((*staged, bufs["ph"]), bufs)
                if pending is not None:
                    finish(pending)
                pending = (b.start, b.count, maps, events)
        if pending is not None:
            finish(pending)
    finally:
        prefetch.close()
        feed.close()
    if progress:
        print()
    return total
