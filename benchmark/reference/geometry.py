"""Frame geometry derived from the raw parameters, as the upstream
processor's config.py derives it (config.py:13-83), and the wideband mode's
geometry (one full CPI a frame, K critically sampled channels)."""

from __future__ import annotations

import fractions
import math


def _nextpow2(i: float) -> int:
    n = 1
    while n < i:
        n *= 2
    return n


def _nearestpow2(i: float) -> int:
    nxt = _nextpow2(i)
    prv = nxt // 2
    return nxt if (nxt - i) < (i - prv) else prv


def derive(p: dict) -> dict:
    """The derived quantities the reference chain needs, from a
    configuration file's parameters."""
    fs = p["input_sample_rate"]
    g = dict(fs=float(fs), int16_scale=float(p.get("int16_scale", 1.0)),
             bins=tuple(float(b) for b in p["clutter_doppler_bins"]),
             window=tuple(p["caf_window"]))
    k = int(p.get("wideband_channels", 0))
    if k >= 2:
        ch_rate = fs / k
        cpi = _nextpow2(ch_rate * p["cpi_seconds_nominal"])
        cpi_s = cpi / ch_rate
        g.update(channels=k, select=tuple(p.get("wideband_channel_select")
                                          or range(k)),
                 taps_per_branch=int(p.get("wideband_taps_per_branch", 12)),
                 cpi_samples=cpi, if_rate=ch_rate,
                 num_range_cells=round(p["max_range_nominal"]
                                       / (2.998e5 / ch_rate)),
                 num_doppler_cells=_nearestpow2(
                     2 * p["max_doppler_nominal"] * cpi_s),
                 frame_len=k * cpi, out_len=cpi, halo=0)
        g["max_doppler"] = g["num_doppler_cells"] / (2 * cpi_s)
        g["max_range"] = g["num_range_cells"] * 2.998e5 / ch_rate
        return g
    cpi = _nextpow2(p["channel_bandwidth"] * p["cpi_seconds_nominal"])
    desired_if = cpi / p["cpi_seconds_nominal"]
    ratio = fractions.Fraction(fs / desired_if).limit_denominator(20)
    up, down = ratio.denominator, ratio.numerator
    if_rate = fs * up / down
    cpi_s = cpi * float(ratio) / fs
    rcw = 2.998e5 / if_rate
    nr = round(p["max_range_nominal"] / rcw)
    nf = _nearestpow2(2 * p["max_doppler_nominal"] * cpi_s)
    chunk = int(math.floor(cpi * down / up))
    chunk -= chunk % 2
    g.update(channels=0, cpi_samples=cpi, up=up, down=down, if_rate=if_rate,
             bandwidth=float(p["channel_bandwidth"]),
             num_range_cells=nr, num_doppler_cells=nf,
             offset_freq=p["input_center_freq"] - p["channel_freq"],
             frame_len=chunk // 2, out_len=cpi // 2, halo=cpi // 4,
             max_doppler=nf / (2 * cpi_s), max_range=nr * rcw)
    return g
