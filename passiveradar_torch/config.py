"""Configuration and derived frame-geometry math (the port's own copy).

Reproduces the derived-parameter semantics of the reference processor's
configuration layer (reference: config.py:6-98) because those quantities —
pow2 CPI length, the rational resampling approximation with denominator <= 20,
pow2 Doppler bin count — define the output frame geometry and therefore the
compatibility surface of the whole framework. The computation here is pure
host-side Python (exact integer / Fraction arithmetic where possible).

Divergences from the reference (documented, deliberate):
  * the ``overlap_cpi: False`` branch is fixed — the reference references an
    undefined key and crashes (reference config.py:77).
  * all values live in a frozen dataclass with explicit names instead of a
    free-form dict, but ``__getitem__`` is provided for dict-style access.
"""

from __future__ import annotations

import dataclasses
import fractions
import math
from typing import Any, Mapping

import yaml


def nextpow2(i: float) -> int:
    """Smallest power of two >= i (reference: config.py:87-90)."""
    n = 1
    while n < i:
        n *= 2
    return n


def nearestpow2(i: float) -> int:
    """Power of two closest to i (reference: config.py:92-98)."""
    nxt = nextpow2(i)
    prv = nxt // 2
    if (nxt - i) < (i - prv):
        return nxt
    return prv


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    # ---- raw input-file options -------------------------------------------------
    input_file: str = ""
    interleaved_input_channels: bool = False
    input_ref_path: str = "/data/ref"
    input_srv_path: str = "/data/srv"
    interleaved_data_path: str = "/data"

    # ---- raw output options -----------------------------------------------------
    range_doppler_map_ftype: str = "hdf5"
    output_fname: str = "XAMBG"
    num_frames: int = 100

    # ---- raw radio parameters ---------------------------------------------------
    input_sample_rate: int = 2_400_000
    input_center_freq: int = 102_000_000
    channel_freq: int = 101_900_000
    channel_bandwidth: int = 200_000

    # ---- raw processing parameters ---------------------------------------------
    cpi_seconds_nominal: float = 2.0
    max_doppler_nominal: float = 256.0
    max_range_nominal: float = 200.0
    overlap_cpi: bool = True

    # ---- framework-specific knobs (no reference analog) -------------------------
    # Wideband / multi-illuminator mode (BASELINE config 4): >= 2 activates
    # the polyphase channelizer front-end — the capture is split into
    # wideband_channels critically-sampled channels, each running its own
    # clutter + CAF chain (wideband.py). Channel k is centred at +k·fs/K.
    wideband_channels: int = 0
    wideband_channel_select: tuple = ()   # PFB channel indices (empty = all)
    wideband_taps_per_branch: int = 12    # PFB prototype length per branch
    clutter_doppler_bins: tuple = (0, 1, -1, 2, -2)  # reference main.py:174
    clutter_method: str = "ls_multiple"  # ls_multiple | nlms | nlms_pallas | none
    # ls_multiple formulation: 'carry' (sequential bins, frequency-domain
    # residual carry), 'coupled' (precoupled batched bins), 'segment'
    # (segment-Gram — the exactness oracle; slower, see docs/PERFORMANCE.md)
    clutter_impl: str = "carry"
    # per-bin Toeplitz solver: 'levinson' (G-S apply via small FFT convs),
    # 'gs_dense' (Levinson + dense G-S inverse, one matvec per bin),
    # 'gs_matrix' (Levinson + dense inverse assembled by batched G-S
    # application to the identity), 'cholesky' (dense factorisation)
    clutter_solver: str = "levinson"
    nlms_mu: float = 0.05                # step size for the nlms methods
    caf_window: tuple = ("kaiser", 5.0)              # reference main.py:183
    caf_short_filt: bool = True          # boxcar vs flattop Doppler decimator
    frame_batch: int = 8      # frames processed per device dispatch
    max_measurements: int = 384  # fixed-shape candidate-measurement budget
    # int16 captures (the native SDR recording format) are shipped to the
    # device raw — half the host->device bytes — and converted to float32
    # on device as x * int16_scale (see io/hdf5.py + pipeline.py)
    int16_scale: float = 1.0
    # Strict frame-for-frame output parity with the reference: it trims the
    # final chunk (reference main.py:116-120, min(N_chunks, num_frames)-1),
    # so its stacks hold one FEWER frame for the same capture. Default off
    # (we keep the last valid frame); enable to diff output files
    # frame-for-frame against reference runs.
    strict_frame_parity: bool = False

    # ---- derived (filled by derive_config) --------------------------------------
    cpi_samples: int = 0
    desired_IF_sample_rate: float = 0.0
    resamp_up: int = 1
    resamp_dn: int = 1
    IF_sample_rate: float = 0.0
    cpi_seconds_actual: float = 0.0
    doppler_cell_width: float = 0.0
    range_cell_width: float = 0.0
    num_range_cells: int = 0
    max_range_actual: float = 0.0
    num_doppler_cells: int = 0
    max_doppler_actual: float = 0.0
    offset_freq: int = 0
    input_chunk_length: int = 0
    output_chunk_length: int = 0
    window_overlap: int = 0
    frame_interval: float = 0.0
    range_doppler_map_fname: str = ""
    meta_fname: str = ""

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    # Number of complex IF samples entering the CAF per frame, including halo.
    @property
    def caf_input_samples(self) -> int:
        return self.output_chunk_length + 2 * self.window_overlap

    # Fixed-shape candidate-pool size for the trackers: at least
    # max_measurements, scaled so the reference's 99.8th-percentile threshold
    # (≈0.2% of cells, plus ties) never truncates on dense frames. Used by
    # both the offline CLI and the streaming processor so they stay identical.
    @property
    def candidate_budget(self) -> int:
        cells = self.num_doppler_cells * (self.num_range_cells + 1)
        return max(self.max_measurements, int(0.003 * cells))


_RAW_KEYS = {
    "input_file", "interleaved_input_channels", "input_ref_path",
    "input_srv_path", "interleaved_data_path", "range_doppler_map_ftype",
    "output_fname", "num_frames", "input_sample_rate", "input_center_freq",
    "channel_freq", "channel_bandwidth", "cpi_seconds_nominal",
    "max_doppler_nominal", "max_range_nominal", "overlap_cpi",
    "clutter_doppler_bins", "clutter_method", "clutter_impl",
    "clutter_solver", "nlms_mu", "caf_window",
    "caf_short_filt", "frame_batch", "max_measurements", "int16_scale",
    "wideband_channels", "wideband_channel_select", "wideband_taps_per_branch",
    "strict_frame_parity",
}


def derive_config(params: Mapping[str, Any]) -> RadarConfig:
    """Compute the full derived parameter set from raw YAML-style parameters.

    Mirrors the reference's derivation chain (config.py:13-83) exactly so the
    output frame geometry is identical.
    """
    raw = {k: v for k, v in params.items() if k in _RAW_KEYS}
    if "clutter_doppler_bins" in raw:
        raw["clutter_doppler_bins"] = tuple(raw["clutter_doppler_bins"])
    if "wideband_channel_select" in raw:
        raw["wideband_channel_select"] = tuple(raw["wideband_channel_select"])
    if "caf_window" in raw:
        raw["caf_window"] = tuple(raw["caf_window"]) if not isinstance(
            raw["caf_window"], str) else raw["caf_window"]
    c = RadarConfig(**raw)
    if c.wideband_channels >= 2:
        return _derive_wideband(c)

    # CPI length in IF samples: power of two (reference config.py:15).
    cpi_samples = nextpow2(c.channel_bandwidth * c.cpi_seconds_nominal)

    # Desired IF rate so that cpi_samples spans cpi_seconds_nominal.
    desired_if = cpi_samples / c.cpi_seconds_nominal

    # Rational resampling factor: nearest fraction with denominator <= 20
    # (reference config.py:24-34). Note: constructed from the *float* ratio,
    # exactly as the reference does, so we reproduce its rounding.
    desired_ratio = fractions.Fraction(c.input_sample_rate / desired_if)
    ratio = desired_ratio.limit_denominator(20)
    resamp_up = ratio.denominator
    resamp_dn = ratio.numerator
    if_rate = c.input_sample_rate * resamp_up / resamp_dn

    cpi_actual = cpi_samples * float(ratio) / c.input_sample_rate
    doppler_cell_width = 1.0 / cpi_actual
    range_cell_width = 2.998e5 / if_rate
    num_range_cells = round(c.max_range_nominal / range_cell_width)
    max_range_actual = num_range_cells * range_cell_width
    num_doppler_cells = nearestpow2(2 * c.max_doppler_nominal * cpi_actual)
    max_doppler_actual = num_doppler_cells / (2 * cpi_actual)
    offset_freq = c.input_center_freq - c.channel_freq

    if c.overlap_cpi:
        input_chunk_length = int(math.floor(cpi_samples * resamp_dn / resamp_up))
        if input_chunk_length % 2 != 0:
            input_chunk_length -= 1
        output_chunk_length = cpi_samples // 2
        window_overlap = cpi_samples // 4
        frame_interval = cpi_actual / 2
    else:
        # Fixed relative to the reference (its non-overlap branch crashes on an
        # undefined key, reference config.py:77): a frame consumes a full CPI.
        input_chunk_length = int(
            math.floor(cpi_samples * resamp_dn / resamp_up)) * 2
        if input_chunk_length % 2 != 0:
            input_chunk_length -= 1
        output_chunk_length = cpi_samples
        window_overlap = 0
        frame_interval = cpi_actual

    return dataclasses.replace(
        c,
        cpi_samples=cpi_samples,
        desired_IF_sample_rate=desired_if,
        resamp_up=resamp_up,
        resamp_dn=resamp_dn,
        IF_sample_rate=if_rate,
        cpi_seconds_actual=cpi_actual,
        doppler_cell_width=doppler_cell_width,
        range_cell_width=range_cell_width,
        num_range_cells=num_range_cells,
        max_range_actual=max_range_actual,
        num_doppler_cells=num_doppler_cells,
        max_doppler_actual=max_doppler_actual,
        offset_freq=offset_freq,
        input_chunk_length=input_chunk_length,
        output_chunk_length=output_chunk_length,
        window_overlap=window_overlap,
        frame_interval=frame_interval,
        range_doppler_map_fname=(
            c.output_fname + "." + c.range_doppler_map_ftype),
        meta_fname=c.output_fname + ".npz",
    )


def _derive_wideband(c: RadarConfig) -> RadarConfig:
    """Derived geometry for the wideband multi-illuminator mode.

    The polyphase channelizer replaces the mixer/resampler front-end: the
    K critically-sampled channels come out at fs/K directly (no rational
    resample, no tuning offset), so the per-channel CAF geometry derives
    from the channel rate. CPIs are non-overlapping (each wideband frame is
    one full CPI across all channels); this is a capability extension over
    the reference, which has no wideband path at all.
    """
    k = c.wideband_channels
    ch_rate = c.input_sample_rate / k
    cpi_samples = nextpow2(ch_rate * c.cpi_seconds_nominal)
    cpi_actual = cpi_samples / ch_rate
    doppler_cell_width = 1.0 / cpi_actual
    range_cell_width = 2.998e5 / ch_rate
    num_range_cells = round(c.max_range_nominal / range_cell_width)
    num_doppler_cells = nearestpow2(2 * c.max_doppler_nominal * cpi_actual)
    select = c.wideband_channel_select or tuple(range(k))
    if any(s < 0 or s >= k for s in select):
        raise ValueError(f"wideband_channel_select {select} outside 0..{k - 1}")
    return dataclasses.replace(
        c,
        overlap_cpi=False,
        wideband_channel_select=select,
        cpi_samples=cpi_samples,
        desired_IF_sample_rate=ch_rate,
        resamp_up=1,
        resamp_dn=1,
        IF_sample_rate=ch_rate,
        cpi_seconds_actual=cpi_actual,
        doppler_cell_width=doppler_cell_width,
        range_cell_width=range_cell_width,
        num_range_cells=num_range_cells,
        max_range_actual=num_range_cells * range_cell_width,
        num_doppler_cells=num_doppler_cells,
        max_doppler_actual=num_doppler_cells / (2 * cpi_actual),
        offset_freq=0,
        input_chunk_length=2 * k * cpi_samples,
        output_chunk_length=cpi_samples,
        window_overlap=0,
        frame_interval=cpi_actual,
        range_doppler_map_fname=(
            c.output_fname + "." + c.range_doppler_map_ftype),
        meta_fname=c.output_fname + ".npz",
    )


def load_config(path: str) -> RadarConfig:
    """Load a YAML configuration file and derive all processing parameters.

    Accepts the reference's YAML schema (PRconfig.yaml:1-44) unchanged.
    """
    with open(path, "r") as f:
        params = yaml.safe_load(f)
    return derive_config(params)
