"""The benchmark's inputs: a ring of frames of a two-channel capture, made
on the device from the seed, in plain PyTorch.

The scene follows the upstream processor's setting: broadcast stations
(constant-envelope, FM-like: the phase is the running sum of smoothed
noise), a reference channel that receives them direct, and a surveillance
channel that receives an attenuated direct copy, static clutter (delayed
copies at zero or a small Doppler), point-target echoes (delayed,
Doppler-shifted copies) and receiver noise. The ring is one contiguous
stream of ``frames · frame_len`` complex samples at the input rate; its
frames follow one another in time, and the last wraps to the first.

FM: one station at the channel, ``offset_freq`` below the capture centre,
as wide as the channel. Wideband: one station in each of the K channels,
at k·fs/K, 0.8 of the channel wide. The mix file gives the rest (``scene``):
amplitudes, delays in input samples and Doppler shifts in Hz.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _station(gen: torch.Generator, n: int, fs: float, offset_hz: float,
             bandwidth_hz: float, device) -> torch.Tensor:
    """A constant-envelope FM-like station at ``offset_hz``: complex128."""
    smooth = max(1, int(fs // (1.5 * bandwidth_hz)))
    msg = torch.randn(n + smooth - 1, generator=gen, dtype=torch.float64,
                      device=device)
    c = torch.nn.functional.pad(torch.cumsum(msg, 0), (1, 0))
    msg = (c[smooth:] - c[:-smooth]) / smooth
    dev_hz = 0.4 * bandwidth_hz / 2
    cyc = torch.cumsum(msg, 0) * (dev_hz / fs)
    cyc = cyc + torch.arange(n, dtype=torch.float64, device=device) * (
        offset_hz / fs)
    return torch.polar(torch.ones_like(cyc), 2 * math.pi * torch.remainder(
        cyc, 1.0))


def stations(g: dict) -> list:
    """(offset Hz, bandwidth Hz, amplitude) of each station of the
    configuration's band."""
    if g["channels"]:
        k, fs = g["channels"], g["fs"]
        out = []
        for c in range(k):
            f = c * fs / k
            out.append((f - fs if f >= fs / 2 else f, 0.8 * fs / k,
                        1.0 / math.sqrt(k)))
        return out
    return [(-float(g["offset_freq"]), float(g["bandwidth"]), 1.0)]


def _doppler(x: torch.Tensor, hz: float, fs: float) -> torch.Tensor:
    n = x.shape[0]
    cyc = torch.remainder(torch.arange(n, dtype=torch.float64,
                                       device=x.device) * (hz / fs), 1.0)
    return x * torch.polar(torch.ones_like(cyc), 2 * math.pi * cyc)


def make_ring(g: dict, scene: dict, frames: int, seed: int,
              device) -> tuple:
    """(ref, srv): two (frames, frame_len) complex128 tensors on
    ``device``, the ring's contiguous stream cut into frames."""
    n = frames * g["frame_len"]
    fs = g["fs"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sig = None
    for off, bw, amp in stations(g):
        s = amp * _station(gen, n, fs, off, bw, device)
        sig = s if sig is None else sig + s
    srv = scene["direct_gain"] * sig
    for c in scene.get("clutter", []):
        srv = srv + c["amplitude"] * _doppler(
            torch.roll(sig, c["delay_samples"]), c.get("doppler_hz", 0.0), fs)
    for t in scene["targets"]:
        srv = srv + t["amplitude"] * _doppler(
            torch.roll(sig, t["delay_samples"]), t["doppler_hz"], fs)
    noise = scene["noise"]

    def noisy(x):
        w = torch.randn((2, n), generator=gen, dtype=torch.float64,
                        device=device)
        return x + noise * torch.complex(w[0], w[1])

    ref, srv = noisy(sig), noisy(srv)
    return (ref.reshape(frames, g["frame_len"]),
            srv.reshape(frames, g["frame_len"]))


def to_int16_pairs(x: torch.Tensor, scale: float) -> np.ndarray:
    """A complex ring as host int16 IQ pairs (frames, frame_len, 2) at
    ``scale`` (the SDR's recording format: x ≈ int16 · scale)."""
    q = torch.view_as_real(x) / scale
    q = torch.clamp(torch.round(q), -32768, 32767).to(torch.int16)
    return q.cpu().numpy()


def to_complex64(x: torch.Tensor) -> np.ndarray:
    """A complex ring as host complex64 (frames, frame_len)."""
    return x.to(torch.complex64).cpu().numpy()
