"""Streaming (real-time) processing mode (counterpart of the JAX package's
streaming.py).

Push raw CPI chunks as they arrive from an SDR; each push advances the full
chain — preprocess → clutter-cancel → halo-complete CAF → CFAR → multitarget
tracker — and returns the finished results for the *previous* frame (the 50%
CPI overlap makes one frame of latency inherent: frame f's CAF needs the head
of frame f+1, reference main.py:178-181).

All state that the reference keeps implicitly in its offline batch graph
(neighbour chunks for the overlap, the per-block mixing phase, tracker state)
is carried explicitly on the device, so the processor runs indefinitely with
O(1) memory.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.detect.trackers import init_tracks, \
    multitarget_step, to_host
from passiveradar_torch.ops import graphs
from passiveradar_torch.ops.caf import device_window, fast_xambg
from passiveradar_torch.ops.cfar import cfar_2d
from passiveradar_torch.ops.util import to_host_complex
from passiveradar_torch.pipeline import _clean_batch, _to_device, \
    frame_phases
from passiveradar_torch.spans import span

DETAILS = ("full", "summary")


def _track_summary(tracks) -> torch.Tensor:
    """Pack the per-track scalars into one (…, n_tracks, 6) float32 tensor
    (a leading channel axis rides along).

    Columns: status, lifetime, estimate (range, doppler), last measurement
    (range, doppler). One small device-to-host copy replaces the full
    track table's (the Kalman covariances etc. stay on the device) — the
    cheap leg of the summary mode.
    """
    return torch.stack([
        tracks["status"].to(torch.float32),
        tracks["lifetime"].to(torch.float32),
        tracks["estimate"][..., 0], tracks["estimate"][..., 1],
        tracks["measurement"][..., 0], tracks["measurement"][..., 1],
    ], dim=-1)


def _fetch_summary(tracks) -> dict:
    a = _track_summary(tracks).cpu().numpy()
    return {
        "status": a[..., 0].astype(np.int32),
        "lifetime": a[..., 1].astype(np.int32),
        "estimate": a[..., 2:4],
        "measurement": a[..., 4:6],
    }


def _caf_cfar(left_r, ref, right_r, left_s, srv, right_s, cfg: RadarConfig,
              window, cfar_kernel: tuple) -> tuple:
    """One frame's halo-complete CAF and its CFAR map (the JAX package's
    ``_assemble_caf_cfar``): ref and srv (n,) with their (h,) halos →
    (num_doppler_cells, num_range_cells+1) complex64 and float32."""
    caf = fast_xambg(torch.cat([left_r, ref, right_r]),
                     torch.cat([left_s, srv, right_s]), cfg.num_range_cells,
                     cfg.num_doppler_cells, window=window,
                     short_filt=cfg.caf_short_filt)
    return caf, cfar_2d(caf.abs(), *cfar_kernel)


@dataclasses.dataclass
class StreamResult:
    frame_index: int
    caf: Optional[np.ndarray]    # (num_doppler, num_range+1) complex64;
    #                              None in detail="summary" mode
    cfar: Optional[np.ndarray]   # same orientation as caf; None in summary mode
    tracks: Optional[dict]       # full track-table snapshot; None in summary mode
    summary: Optional[dict] = None   # detail="summary": {status, lifetime,
    #                                  estimate, measurement} host arrays


class StreamingProcessor:
    """Real-time frame-at-a-time processor with carried tracker state.

    ``detail`` selects the per-push result weight: "full" (default) copies
    the CAF + CFAR maps and the whole track table to the host every CPI;
    "summary" copies only a packed track summary (see _track_summary), with
    the latest maps still available on demand via fetch_maps(). ``device``
    is where the chain runs (default: the CUDA card).
    """

    def __init__(self, cfg: RadarConfig, n_tracks: int = 10,
                 cfar_kernel: tuple = (18, 4), detail: str = "full",
                 device=None):
        if detail not in DETAILS:
            raise ValueError(f"unknown detail mode {detail!r}")
        self.dev = resolve_device(device)
        self.cfg = cfg
        self.n_tracks = n_tracks
        self.cfar_kernel = cfar_kernel
        self.detail = detail
        self._last_maps = None
        self._left_tail = None
        self._tracks = init_tracks(n_tracks, self.dev)
        self._extent = torch.tensor(
            (cfg.max_doppler_actual, cfg.max_range_actual),
            dtype=torch.float32, device=self.dev)
        if self.dev.type == "cuda":
            self._warm()
        self._hist: list = []    # [(index, ref_if, srv_clean)] last frame
        self._index = 0
        self._window = device_window(cfg.caf_window, cfg.caf_input_samples,
                                     self.dev)

    def _warm(self) -> None:
        """One CFAR pass and one tracker step on a zero frame and a scratch
        table, kept nowhere: the first use of the tracker kernel's library,
        cuDNN and top-k is paid when the processor is made on the card, not
        by its first push."""
        frame = torch.zeros((self.cfg.num_doppler_cells,
                             self.cfg.num_range_cells + 1), device=self.dev)
        multitarget_step(init_tracks(self.n_tracks, self.dev),
                         cfar_2d(frame, *self.cfar_kernel), self._extent,
                         self.n_tracks, self.cfg.candidate_budget)

    def _clean(self, raw_ref, raw_srv):
        cfg = self.cfg

        def ship(raw):
            # a tensor on the device is used as it is; numpy or a host
            # tensor goes over once: float32 interleaved IQ or complex64
            return _to_device(raw, self.dev)[None]

        with span("push.upload"):
            ref, srv = ship(raw_ref), ship(raw_srv)
        with span("push.launch"):
            # both preprocesses and the clutter stage: one graph on the card
            return _clean_batch(ref, srv, frame_phases(cfg, [self._index]),
                                cfg, device=self.dev)

    def _finish(self, prev, cur, last: bool = False,
                detail: Optional[str] = None) -> StreamResult:
        cfg = self.cfg
        detail = self.detail if detail is None else detail
        idx, ref_c, srv_c = prev
        h = cfg.window_overlap
        n = ref_c.shape[1]
        with span("push.launch"):
            zeros = torch.zeros(h, dtype=ref_c.dtype, device=ref_c.device)
            left_r, left_s = (zeros, zeros) if idx == 0 else self._left_tail
            # :h and n - h: (not -h) so h == 0 (overlap_cpi: false) gives
            # empty halos instead of the whole frame
            right_r, right_s = (zeros, zeros) if last else \
                (cur[0][0, :h], cur[1][0, :h])
            # the CAF and the CFAR: one graph on the card; the tracker step
            # (its own kernel) stays outside
            cfar_kernel = tuple(self.cfar_kernel)
            caf, cf = graphs.graphed(
                "stream_caf", functools.partial(
                    _caf_cfar, cfg=cfg, window=self._window,
                    cfar_kernel=cfar_kernel),
                (left_r, ref_c[0], right_r, left_s, srv_c[0], right_s),
                (cfg, cfar_kernel))
            self._tracks = multitarget_step(self._tracks, cf, self._extent,
                                            self.n_tracks,
                                            cfg.candidate_budget)
        self._left_tail = (ref_c[0, n - h:], srv_c[0, n - h:])
        self._last_maps = (caf, cf)
        with span("push.fetch"):
            if detail == "summary":
                return StreamResult(
                    frame_index=idx, caf=None, cfar=None, tracks=None,
                    summary=_fetch_summary(self._tracks),
                )
            return StreamResult(
                frame_index=idx,
                caf=to_host_complex(caf),
                cfar=cf.cpu().numpy(),
                tracks=to_host(self._tracks),
            )

    def fetch_maps(self):
        """Copy the most recently finished frame's (caf, cfar) maps to the
        host. The on-demand companion to ``detail="summary"`` pushes;
        returns None before the first finished frame."""
        if self._last_maps is None:
            return None
        caf, cf = self._last_maps
        with span("push"), span("push.fetch"):
            return to_host_complex(caf), cf.cpu().numpy()

    def push(self, raw_ref, raw_srv,
             detail: Optional[str] = None) -> Optional[StreamResult]:
        """Feed one frame's raw chunk per channel (interleaved float32 of
        length input_chunk_length, or complex64 of half that; numpy or a
        tensor, which is not copied through the host). Returns the
        completed result for the previous frame, or None for the first
        push. ``detail`` overrides the processor default for this push
        ("full" / "summary" — see the class docstring)."""
        if detail is not None and detail not in DETAILS:
            raise ValueError(f"unknown detail mode {detail!r}")
        with span("push"):
            cleaned = self._clean(raw_ref, raw_srv)
            result = None
            if self._hist:
                result = self._finish(self._hist[-1], cleaned, detail=detail)
        self._hist = [(self._index, *cleaned)]
        self._index += 1
        return result

    def flush(self, detail: Optional[str] = None) -> Optional[StreamResult]:
        """Finish the final in-flight frame (zero right halo at stream
        end)."""
        if not self._hist:
            return None
        with span("push"):
            result = self._finish(self._hist[-1], None, last=True,
                                  detail=detail)
        self._hist = []
        return result
