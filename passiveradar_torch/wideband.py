"""Wideband / multi-illuminator processing (counterpart of the JAX package's
wideband.py; BASELINE configs 4 and 5).

For wideband captures (DVB-T-class bands, or a band spanning several FM
stations) the capture is first split by the polyphase channelizer
(ops/channelizer.py); each channel then runs its own clutter-cancellation +
CAF chain. Where the JAX package ``vmap``s the chain over channels (and
frames), here every selected channel of every frame is one row of a single
(F·S, n) batch through ``ls_filter_multiple`` and ``fast_xambg``, which
take batches.

Surfaces:
  * ``process_wideband_frame``: the core library op (explicit parameters).
  * ``wideband_frames`` / ``run_wideband_capture``: the config-driven batch
    pipeline and host loop (activated by ``wideband_channels`` in the YAML;
    per-channel output stacks land in ``<output>.chK.<ftype>``).
  * ``WidebandStreamingProcessor``: real-time push-per-CPI processing with
    per-channel CAF + CFAR + multitarget tracking.

``wideband_frames_shmap`` (``run_wideband_capture(mesh=...)``, ``cli.wideband
--shard``) splits the selected channels over the devices of a mesh. The JAX
package's ``_to_complex`` is ``ops/util.as_complex`` here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.detect.trackers import _slot, init_tracks, \
    multitarget_step, to_host
from passiveradar_torch.feed import Batch, CardFeed
from passiveradar_torch.ops.caf import device_window, fast_xambg, \
    resolve_window
from passiveradar_torch.ops.cfar import cfar_2d
from passiveradar_torch.ops.channelizer import channelize, channelize_pair
from passiveradar_torch.ops.clutter import ls_filter_multiple_graphed
from passiveradar_torch.ops.util import as_complex, to_host_complex
from passiveradar_torch.pipeline import _as_tensor
from passiveradar_torch.spans import span
from passiveradar_torch.streaming import DETAILS, StreamResult, \
    _fetch_summary


def process_wideband_frame(ref, srv, n_channels: int, range_bins: int,
                           freq_bins: int, filter_len: int,
                           sample_rate: float, doppler_bins: tuple = (0,),
                           window=None, device=None) -> torch.Tensor:
    """One wideband CPI → per-channel range-Doppler maps (K, nf, R+1).

    ref/srv: (N,) wideband complex64 at ``sample_rate`` (tensors stay on
    their device; numpy goes to ``device``, the CUDA card by default). Each
    of the K critically sampled channels is clutter-cancelled against its
    own reference channel and correlated into a CAF frame. Samples past the
    last whole multiple of freq_bins in a channel are dropped.
    """
    refc, srvc = channelize_pair(ref, srv, n_channels, device=device)
    m = refc.shape[0]
    ch_rate = float(sample_rate) / n_channels
    usable = (m // freq_bins) * freq_bins
    refc = refc[:usable].T.contiguous()          # (K, M)
    srvc = srvc[:usable].T.contiguous()
    win = resolve_window(window, usable)
    if isinstance(win, np.ndarray):
        win = torch.from_numpy(win).to(refc.device)
    clean = ls_filter_multiple_graphed(refc, srvc, filter_len, ch_rate,
                                       doppler_bins)
    return fast_xambg(refc, clean, range_bins, freq_bins, window=win)


def integrate_channels(maps: torch.Tensor) -> torch.Tensor:
    """Noncoherent multi-illuminator integration: Σ_k |CAF_k| over channels.

    Valid when the channels share the bistatic geometry (same transmitter
    site); range cells are in per-channel sample units, identical across
    channels because all channels share one sample rate.
    """
    return maps.abs().sum(dim=0)


# --------------------------------------------------------------------------
# config-driven pipeline (BASELINE config 4)
# --------------------------------------------------------------------------

def channel_path(cfg: RadarConfig, k: int) -> str:
    """Output stack path for PFB channel k (plot/track tools read these)."""
    return f"{cfg.output_fname}.ch{k}.{cfg.range_doppler_map_ftype}"


def integrated_path(cfg: RadarConfig) -> str:
    """Output stack path for the noncoherently integrated multi-channel map
    (integrate_channels over the selected channels; same /xambg contract as
    a per-channel stack, so the plot/track tools read it unchanged)."""
    return f"{cfg.output_fname}.integrated.{cfg.range_doppler_map_ftype}"


def channel_inputs(raw_ref, raw_srv, cfg: RadarConfig, device=None):
    """Channelize a wideband frame batch and keep the selected channels:
    raw_* (F, N) complex64 or (F, N, 2) float32 IQ pairs →
    (F·len(select), cpi_samples) complex64 ref and srv, frame-major."""
    sel = list(cfg.wideband_channel_select)
    refc, srvc = channelize_pair(
        as_complex(on_device(raw_ref, device)),
        as_complex(on_device(raw_srv, device)), cfg.wideband_channels,
        taps_per_branch=cfg.wideband_taps_per_branch)        # (F, m, K)

    def pick(c):
        return c.transpose(1, 2)[:, sel].reshape(-1, cfg.cpi_samples)

    return pick(refc), pick(srvc)


def channel_clean(refc: torch.Tensor, srvc: torch.Tensor,
                  cfg: RadarConfig) -> torch.Tensor:
    """The per-channel LS clutter canceller over a (B, cpi_samples) batch of
    channels (the JAX package's default impl and solver, whatever
    cfg.clutter_method says, as there); a replayed CUDA graph on the card
    (ops/clutter.ls_filter_multiple_graphed)."""
    return ls_filter_multiple_graphed(refc, srvc, cfg.num_range_cells,
                                      cfg.IF_sample_rate,
                                      cfg.clutter_doppler_bins)


def channel_caf(refc: torch.Tensor, clean: torch.Tensor,
                cfg: RadarConfig) -> torch.Tensor:
    """The per-channel windowed CAF over a (B, cpi_samples) batch →
    (B, num_doppler_cells, num_range_cells+1) complex64."""
    win = device_window(cfg.caf_window, cfg.cpi_samples, refc.device)
    return fast_xambg(refc, clean, cfg.num_range_cells,
                      cfg.num_doppler_cells, window=win,
                      short_filt=cfg.caf_short_filt)


def wideband_frames(raw_ref, raw_srv, cfg: RadarConfig,
                    device=None) -> torch.Tensor:
    """Wideband frame batch → per-channel range-Doppler maps.

    raw_*: (F, N) complex64 or (F, N, 2) float32 IQ pairs with
    N = wideband_channels · cpi_samples (one full CPI per frame: wideband
    CPIs are non-overlapping, config._derive_wideband); tensors stay on
    their device, numpy goes to ``device`` (the CUDA card by default).
    Returns (F, len(select), num_doppler_cells, num_range_cells+1)
    complex64.
    """
    refc, srvc = channel_inputs(raw_ref, raw_srv, cfg, device)
    maps = channel_caf(refc, channel_clean(refc, srvc, cfg), cfg)
    return maps.reshape((-1, len(cfg.wideband_channel_select))
                        + maps.shape[1:])


def wideband_frames_shmap(raw_ref, raw_srv, cfg: RadarConfig,
                          mesh) -> list:
    """wideband_frames with the selected channels split over ``mesh``
    (parallel/mesh.FrameMesh), the per-illuminator parallel axis.

    The channelizer is not repeated on every shard: the input's time axis
    is split, and each shard branch-filters and FFTs its own time block on
    its device. That is exact because the per-branch FIR is causal: the
    left neighbour's last taps_per_branch − 1 polyphase rows are the
    block's halo (zero on shard 0, as the global zero pad). Each shard
    keeps the selected channels of its block; copies then gather every
    time block of shard j's channel block onto shard j (the JAX package's
    tiled all_to_all), and each shard runs its channels' clutter and CAF
    chains. raw_*: as for wideband_frames (numpy or tensors). The selected
    channels and cpi_samples must divide the mesh. Returns the per-shard
    (F, len(select)/n, num_doppler_cells, num_range_cells+1) complex64 map
    blocks in channel order, each on its shard's device.
    """
    n = len(mesh)
    k = cfg.wideband_channels
    t = cfg.wideband_taps_per_branch
    sel = list(cfg.wideband_channel_select)
    if len(sel) % n:
        raise ValueError(f"wideband_frames_shmap: {len(sel)} selected "
                         f"channels do not divide the {n}-shard mesh")
    if cfg.cpi_samples % n:
        raise ValueError(f"wideband_frames_shmap: {cfg.cpi_samples} "
                         f"per-channel samples do not divide the {n}-shard "
                         "mesh")
    mb = cfg.cpi_samples // n               # channel-rate samples a shard
    if mb < t - 1:
        raise ValueError(f"wideband_frames_shmap: {mb} samples a shard are "
                         f"fewer than the FIR's {t - 1}-row halo")
    sl = len(sel) // n                      # channels a shard

    def channel_blocks(raw):
        x = as_complex(_as_tensor(raw))
        f = x.shape[0]
        xbs = [b.reshape(f, mb, k).to(dev, non_blocking=True)
               for b, dev in zip(torch.chunk(x[:, :n * mb * k], n, dim=1),
                                 mesh.devices)]
        picked = []
        for i, (xb, dev) in enumerate(zip(xbs, mesh.devices)):
            halo = xbs[i - 1][:, mb - (t - 1):].to(dev, non_blocking=True) \
                if i > 0 else torch.zeros((f, t - 1, k), dtype=xb.dtype,
                                          device=dev)
            ext = torch.cat([halo, xb], dim=1)          # (F, mb+t-1, K)
            # rows from t-1 on have their whole causal FIR history
            picked.append(channelize(ext.reshape(f, -1), k, t)
                          [:, t - 1:, sel])
        # (time block, all selected channels) → (all time, own channels)
        out = []
        for j, dev in enumerate(mesh.devices):
            mine = torch.cat([p[:, :, j * sl:(j + 1) * sl].to(
                dev, non_blocking=True) for p in picked], dim=1)
            out.append(mine.transpose(1, 2).reshape(-1, cfg.cpi_samples))
        return out

    maps = []
    for refc, srvc in zip(channel_blocks(raw_ref), channel_blocks(raw_srv)):
        m = channel_caf(refc, channel_clean(refc, srvc, cfg), cfg)
        maps.append(m.reshape((-1, sl) + m.shape[1:]))
    return maps


def run_wideband_capture(reader, cfg: RadarConfig,
                         batch_frames: int | None = None,
                         writers: dict | None = None,
                         progress: bool = True, integrate: bool = False,
                         device=None, mesh=None) -> int:
    """Host loop: stream a wideband capture into per-channel map stacks on
    ``device`` (default: the CUDA card).

    ``writers``: {channel_index: MapWriter-like} (default: one MapWriter per
    selected channel at channel_path(cfg, k)). Every batch has one fixed
    shape (a zero-padded final batch) and is assembled by a feed.CardFeed:
    each CPI is read once and, on one card, sent once, in chunks through
    pinned slots on a copy stream; on the CPU and under a mesh the feed's
    buffers are host tensors. ``integrate``: also write the
    noncoherently integrated multi-illuminator stack (integrate_channels,
    summed on the device before the copy to the host) to
    integrated_path(cfg), in the same /xambg file contract. ``mesh``
    (parallel/mesh.FrameMesh): split the selected channels over its
    devices (wideband_frames_shmap); ``device`` is then ignored. Returns
    the number of CPIs.
    """
    from passiveradar_torch.io.hdf5 import PrefetchReader
    from passiveradar_torch.io.writers import MapWriter

    with span("capture.open"):
        dev = resolve_device(device) if mesh is None else None
        total = min(reader.num_frames, cfg.num_frames)
        bf = batch_frames or cfg.frame_batch
        select = cfg.wideband_channel_select
        own_writers = writers is None
        if own_writers:
            writers = {k: MapWriter(cfg, total, channel_path(cfg, k))
                       for k in select}
        int_writer = MapWriter(cfg, total, integrated_path(cfg)) \
            if integrate else None

        # wideband CPIs do not overlap: a batch's buffer holds its own CPIs
        # in slots 1..count, and the feed zeroes every other slot
        batches = [Batch(s, min(bf, total - s), s, min(s + bf, total))
                   for s in range(0, total, bf)]
        prefetch = PrefetchReader(reader, [b.read for b in batches],
                                  mode="iq")
        # on one card the CPIs stream to the card; on the CPU and under a
        # mesh the feed's buffers are host tensors
        feed = CardFeed(bf + 2, cfg.input_chunk_length // 2, torch.float32,
                        dev if mesh is None else torch.device("cpu"))
    done = 0
    reads = iter(prefetch)
    try:
        for batch in batches:
            with span("capture.batch"):
                with span("capture.read"):
                    start, count, raws = next(reads)
                with span("capture.stage"):
                    buf_ref, buf_srv = (x[1:bf + 1]
                                        for x in feed.stage(batch, raws))
                with span("capture.launch"):
                    blocks = [wideband_frames(buf_ref, buf_srv, cfg,
                                              device=dev)] \
                        if mesh is None else \
                        wideband_frames_shmap(buf_ref, buf_srv, cfg, mesh)
                    if int_writer is not None:
                        parts = [b[:count].abs().sum(dim=1) for b in blocks]
                    feed.consumed()
                with span("capture.wait"):
                    # (count, S, nf, R+1), the shards' channel blocks in
                    # order
                    maps = torch.cat([b[:count].cpu() for b in blocks],
                                     dim=1).numpy()
                    if int_writer is not None:
                        integ = sum(x.cpu() for x in parts).numpy()
                with span("capture.write"):
                    for i, k in enumerate(select):
                        writers[k].write(maps[:, i], start)
                    if int_writer is not None:
                        int_writer.write(integ.astype(np.complex64), start)
                    done += count
                    if progress:
                        print(f"\r  processed {done}/{total} wideband CPIs",
                              end="", flush=True)
    finally:
        prefetch.close()
        feed.close()
        if own_writers:
            for w in writers.values():
                w.close()
        if int_writer is not None:
            int_writer.close()
    if progress:
        print()
    return total


# --------------------------------------------------------------------------
# streaming multi-illuminator mode (BASELINE config 5)
# --------------------------------------------------------------------------

class WidebandStreamingProcessor:
    """Real-time wideband processor: one push per wideband CPI.

    Each push channelizes the CPI, runs per-channel clutter + CAF + CFAR as
    one batch on ``device`` (default: the CUDA card), then advances an
    independent multitarget tracker per selected channel (each illuminator
    has its own bistatic geometry), all of them in one step. Unlike the
    narrowband StreamingProcessor there is no one-frame latency: wideband
    CPIs are non-overlapping, so results return immediately.
    """

    def __init__(self, cfg: RadarConfig, n_tracks: int = 10,
                 cfar_kernel: tuple = (18, 4), detail: str = "full",
                 device=None):
        if cfg.wideband_channels < 2:
            raise ValueError("cfg.wideband_channels must be >= 2; "
                             "set it in the YAML to enable wideband mode")
        if detail not in DETAILS:
            raise ValueError(f"unknown detail mode {detail!r}")
        self.dev = resolve_device(device)
        self.cfg = cfg
        self.n_tracks = n_tracks
        self.cfar_kernel = cfar_kernel
        self.detail = detail
        self._last_maps = None
        # every selected channel's table, leaves (channels, n_tracks, …)
        channels = len(cfg.wideband_channel_select)
        self._tracks = init_tracks(n_tracks, self.dev, channels)
        self._extent = torch.tensor(
            (cfg.max_doppler_actual, cfg.max_range_actual),
            dtype=torch.float32, device=self.dev)
        if self.dev.type == "cuda":
            self._warm()
        self._index = 0

    def _warm(self) -> None:
        """One CFAR pass and one tracker step for every selected channel on
        zero frames and a scratch table, kept nowhere: the first use of the
        tracker kernel's library, cuDNN and top-k is paid when the
        processor is made on the card, not by its first push."""
        channels = len(self.cfg.wideband_channel_select)
        frames = torch.zeros((channels, self.cfg.num_doppler_cells,
                              self.cfg.num_range_cells + 1), device=self.dev)
        multitarget_step(init_tracks(self.n_tracks, self.dev, channels),
                         cfar_2d(frames, *self.cfar_kernel), self._extent,
                         self.n_tracks, self.cfg.candidate_budget)

    def maps(self, raw_ref, raw_srv):
        """One wideband CPI → per-channel (caf, cfar) stacks on the device,
        each (len(select), num_doppler_cells, num_range_cells+1)."""
        maps = wideband_frames(on_device(raw_ref, self.dev)[None],
                               on_device(raw_srv, self.dev)[None],
                               self.cfg)[0]
        return maps, cfar_2d(maps.abs(), *self.cfar_kernel)

    def track(self, cf: torch.Tensor) -> None:
        """Advance every selected channel's tracker by its CFAR frame, all
        channels in one step."""
        self._tracks = multitarget_step(self._tracks, cf, self._extent,
                                        self.n_tracks,
                                        self.cfg.candidate_budget)

    def push(self, raw_ref, raw_srv,
             detail: Optional[str] = None) -> dict:
        """Feed one wideband CPI per radar channel (complex64 of
        wideband_channels·cpi_samples, or its float32 IQ-pair view; numpy or
        a tensor, which is not copied through the host). Returns
        {channel_index: StreamResult} for this CPI. ``detail`` overrides the
        constructor's for this push: in "summary" mode the per-channel map
        and table copies are skipped and each StreamResult carries only the
        packed track summary; the maps stay on the device, fetchable with
        fetch_maps()."""
        detail = self.detail if detail is None else detail
        if detail not in DETAILS:
            raise ValueError(f"unknown detail mode {detail!r}")
        with span("push"):
            with span("push.upload"):
                raw_ref = on_device(raw_ref, self.dev)
                raw_srv = on_device(raw_srv, self.dev)
            with span("push.launch"):
                maps, cf = self.maps(raw_ref, raw_srv)
                self._last_maps = (maps, cf)
                self.track(cf)
            with span("push.fetch"):
                results = self._results(maps, cf, detail)
        self._index += 1
        return results

    def _results(self, maps, cf, detail: str) -> dict:
        """{channel_index: StreamResult} of this CPI on the host: every
        channel's summary (one copy) or table at once, then each channel's
        slice of it."""
        if detail == "summary":
            summary = _fetch_summary(self._tracks)
        else:
            tables = to_host(self._tracks)
        results = {}
        for i, k in enumerate(self.cfg.wideband_channel_select):
            if detail == "summary":
                results[k] = StreamResult(
                    frame_index=self._index, caf=None, cfar=None,
                    tracks=None, summary=_slot(summary, i))
            else:
                results[k] = StreamResult(
                    frame_index=self._index,
                    caf=to_host_complex(maps[i]),
                    cfar=cf[i].cpu().numpy(),
                    tracks=_slot(tables, i))
        return results

    def fetch_maps(self) -> dict | None:
        """Copy the latest CPI's per-channel (caf, cfar) maps to the host:
        the on-demand companion to detail="summary" pushes. Returns
        {channel_index: (caf, cfar)}, or None before the first push."""
        if self._last_maps is None:
            return None
        maps, cf = self._last_maps
        with span("push"), span("push.fetch"):
            return {k: (to_host_complex(maps[i]), cf[i].cpu().numpy())
                    for i, k in enumerate(self.cfg.wideband_channel_select)}
