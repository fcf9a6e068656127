"""Synthetic two-channel FM capture generation (numpy; port of the host part
of the JAX package's io/synthetic.py).

Captures follow the reference's HDF5 format (PRconfig.yaml:1-21): per
channel a stream of real interleaved IQ samples at the input rate, the radio
channel ``offset_freq`` away from the capture centre. The reference channel
receives the direct signal; the surveillance channel an attenuated direct
copy (clutter) plus point-target echoes with bistatic delay and Doppler,
plus receiver noise. Each injected target must reappear at its (delay,
Doppler) cell of the range-Doppler maps. ``wideband_capture_arrays`` makes
the wideband counterpart: a station in each selected channel of a
channelized band and one echo (the scene of the JAX package's wideband
tests). ``synth_capture_device`` computes the FM scene on the device, in
float32, as per-frame chunks: a capture of tens of frames is there in
seconds, where numpy on the host would take minutes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from passiveradar_torch._device import resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.io.writers import hdf5_backend, zarr_backend
from passiveradar_torch.ops.mixer import frequency_shift


@dataclasses.dataclass(frozen=True)
class Target:
    delay_samples: int      # bistatic delay at the *input* sample rate
    doppler_hz: float       # Doppler shift
    amplitude: float        # echo amplitude relative to the direct signal


def _fm_like_baseband(rng, n: int, bandwidth: float, fs: float) -> np.ndarray:
    """A noise-modulated FM-ish signal: constant envelope, ~bandwidth wide."""
    dev = 0.4 * bandwidth / 2
    msg = rng.standard_normal(n)
    msg = np.convolve(msg, np.ones(8) / 8, mode="same")
    phase = 2 * np.pi * dev * np.cumsum(msg) / fs
    return np.exp(1j * phase)


def synth_capture_arrays(cfg: RadarConfig, n_frames: int,
                         targets=(Target(30, 12.0, 0.05),),
                         direct_gain: float = 0.5,
                         noise_level: float = 1e-3,
                         channel_offset: int = 0,
                         seed: int = 0):
    """(ref_stream, srv_stream) real interleaved float32 IQ arrays, long
    enough for ``n_frames`` frames (plus one, plus the offset margin).
    ``channel_offset`` > 0 delays the surveillance channel."""
    rng = np.random.default_rng(seed)
    fs = float(cfg.input_sample_rate)
    n_complex = (cfg.input_chunk_length // 2) * (n_frames + 1) + abs(
        channel_offset)

    base = _fm_like_baseband(rng, n_complex, cfg.channel_bandwidth, fs)
    t = np.arange(n_complex) / fs
    # the channel sits at -offset_freq so the pipeline's shift brings it home
    carrier = np.exp(-1j * 2 * np.pi * cfg.offset_freq * t)

    ref = base * carrier
    srv = direct_gain * base
    for tg in targets:
        echo = np.roll(base, tg.delay_samples) * np.exp(
            1j * 2 * np.pi * tg.doppler_hz * t)
        srv = srv + tg.amplitude * echo
    srv = srv * carrier
    srv = srv + noise_level * (rng.standard_normal(n_complex)
                               + 1j * rng.standard_normal(n_complex))
    ref = ref + noise_level * (rng.standard_normal(n_complex)
                               + 1j * rng.standard_normal(n_complex))

    if channel_offset > 0:
        srv = np.concatenate([np.zeros(channel_offset, complex),
                              srv[:-channel_offset]])
    elif channel_offset < 0:
        srv = np.concatenate([srv[-channel_offset:],
                              np.zeros(-channel_offset, complex)])

    def interleave(x):
        out = np.empty(2 * len(x), np.float32)
        out[0::2] = np.real(x)
        out[1::2] = np.imag(x)
        return out

    return interleave(ref), interleave(srv)


def _cumsum(x: torch.Tensor, row: int = 4096) -> torch.Tensor:
    """Inclusive cumsum of a 1-D float32 tensor that is the same on every
    run: rows of ``row`` samples scanned on the device, one row a thread
    block in a fixed order, and the row totals carried on the host. (A
    1-D cumsum on CUDA takes partial sums in whatever order the thread
    blocks meet, so its float32 result changes from run to run.)"""
    n = x.shape[0]
    rows = torch.nn.functional.pad(x, (0, -n % row)).reshape(-1, row)
    rows = torch.cumsum(rows, dim=1)
    carry = np.concatenate([[0.0], np.cumsum(
        rows[:-1, -1].double().cpu().numpy())])
    rows += torch.from_numpy(carry.astype(np.float32)).to(x.device)[:, None]
    return rows.reshape(-1)[:n]


def synth_capture_device(cfg: RadarConfig, n_frames: int,
                         targets=(Target(30, 12.0, 0.05),),
                         direct_gain: float = 0.5,
                         noise_level: float = 1e-3,
                         seed: int = 0,
                         complex_output: bool = False,
                         device=None):
    """The scene of synth_capture_arrays computed on ``device`` (default
    CUDA) in float32, as per-frame chunks: (ref, srv), each
    (n_frames, input_chunk_length) float32 interleaved IQ, or with
    ``complex_output`` (n_frames, input_chunk_length//2) complex64.
    The same seed gives the same output on every run.

    The stream is exactly n_frames frames long (no extra frame, no channel
    offset). The message is smoothed by an 8-tap running mean taken as a
    difference of its cumsum, each echo is ``base`` rolled over the whole
    stream, and the random numbers come from one torch.Generator seeded
    with ``seed``, drawn in the order message, ref noise (re, im), srv
    noise (re, im): the values differ from the JAX package's jax.random
    draws, the scene does not.
    """
    dev = resolve_device(device)
    half = cfg.input_chunk_length // 2
    n = half * n_frames
    fs = float(cfg.input_sample_rate)
    dev_hz = 0.4 * cfg.channel_bandwidth / 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(size):
        return torch.randn(size, generator=gen, device=dev,
                           dtype=torch.float32)

    c = _cumsum(normal(n + 8))
    msg = (c[8:] - c[:-8]) / 8.0                        # 8-tap smoother
    del c
    phase = _cumsum(msg).mul_(2 * np.pi * dev_hz / fs)
    del msg
    base = torch.polar(torch.ones_like(phase), phase)
    del phase

    srv = direct_gain * base
    for tg in targets:
        echo = frequency_shift(torch.roll(base, tg.delay_samples),
                               tg.doppler_hz, fs)
        srv.add_(echo, alpha=tg.amplitude)
        del echo
    # place the channel at -offset_freq from the capture centre
    ref = frequency_shift(base, -float(cfg.offset_freq), fs)
    del base
    srv = frequency_shift(srv, -float(cfg.offset_freq), fs)
    for x in (ref, srv):
        x.add_(torch.complex(normal(n), normal(n)), alpha=noise_level)
    ref, srv = ref.reshape(n_frames, half), srv.reshape(n_frames, half)
    if complex_output:
        return ref, srv
    return (torch.view_as_real(ref).reshape(n_frames, cfg.input_chunk_length),
            torch.view_as_real(srv).reshape(n_frames, cfg.input_chunk_length))


def wideband_capture_arrays(cfg: RadarConfig, n_frames: int,
                            delay_samples: int = 8, doppler_hz: float = 6.0,
                            echo: float = 0.1, direct_gain: float = 0.7,
                            noise_level: float = 1e-3, seed: int = 0):
    """(ref_stream, srv_stream) real interleaved float32 IQ arrays of a
    wideband capture: ``n_frames`` CPIs of wideband_channels·cpi_samples
    complex samples. The reference holds one station (8-sample boxcar
    smoothed complex noise) centred in each selected channel; the
    surveillance channel is ``direct_gain`` of it, plus one echo
    ``delay_samples`` wideband samples late (circularly) at ``doppler_hz``,
    plus receiver noise. Complex64 arithmetic throughout, so a capture of
    tens of millions of samples stays a few hundred MB."""
    rng = np.random.default_rng(seed)
    k = cfg.wideband_channels
    n = cfg.cpi_samples * k * n_frames
    idx = np.arange(n)
    phase = idx % k

    def noise():
        out = np.empty(n, np.complex64)
        out.real = rng.standard_normal(n, dtype=np.float32)
        out.imag = rng.standard_normal(n, dtype=np.float32)
        return out

    ref = np.zeros(n, np.complex64)
    for ch in cfg.wideband_channel_select:
        station = np.convolve(noise(), np.ones(8, np.float32) / 8, "same")
        # channel ch's centre, ch·fs/K, turns by ch/K of a cycle a sample
        turn = np.exp(2j * np.pi * (ch * np.arange(k) % k) / k).astype(
            np.complex64)
        ref += station * turn[phase]
    shift = np.exp(2j * np.pi * np.mod(doppler_hz * idx / cfg.input_sample_rate,
                                       1.0)).astype(np.complex64)
    srv = (np.float32(direct_gain) * ref
           + np.float32(echo) * np.roll(ref, delay_samples) * shift
           + np.float32(noise_level) * noise())
    return ref.view(np.float32), srv.view(np.float32)


def _write_capture(path: str, cfg: RadarConfig, ref: np.ndarray,
                   srv: np.ndarray, interleaved: bool | None, dtype) -> None:
    if interleaved is None:
        interleaved = cfg.interleaved_input_channels
    if dtype == np.int16:
        scale = 32000.0 / max(np.max(np.abs(ref)), np.max(np.abs(srv)))
        ref = (ref * scale).astype(np.int16)
        srv = (srv * scale).astype(np.int16)
    if interleaved:
        n_pairs = min(len(ref), len(srv)) // 2
        data = np.empty(4 * n_pairs, dtype=dtype)
        data[0::4] = ref[0:2 * n_pairs:2]
        data[1::4] = ref[1:2 * n_pairs:2]
        data[2::4] = srv[0:2 * n_pairs:2]
        data[3::4] = srv[1:2 * n_pairs:2]
        datasets = {cfg.interleaved_data_path: data}
    else:
        datasets = {cfg.input_ref_path: ref, cfg.input_srv_path: srv}
    if path.endswith(".zarr"):
        zarr = zarr_backend()
        for key, arr in datasets.items():
            z = zarr.open(os.path.join(path, key.strip("/")), mode="w",
                          shape=arr.shape, chunks=(min(arr.size, 1 << 22),),
                          dtype=arr.dtype, compressor=None)
            z[:] = arr
        return
    with hdf5_backend().File(path, "w") as f:
        for key, arr in datasets.items():
            f.create_dataset(key, data=arr)


def write_synth_capture(path: str, cfg: RadarConfig, n_frames: int,
                        interleaved: bool | None = None,
                        dtype=np.float32, **kwargs) -> None:
    """Write a synthetic capture in the reference's layout.

    An HDF5 file (through io/writers.hdf5_backend()), or a zarr v2
    directory store with the same dataset paths when ``path`` ends in
    ``.zarr`` (uncompressed, 4 Mi-element chunks). interleaved=True writes the single-dataset 4-way interleaved
    layout ([refI, refQ, srvI, srvQ, ...]); default follows
    cfg.interleaved_input_channels. dtype int16 emulates SDR captures.
    """
    _write_capture(path, cfg, *synth_capture_arrays(cfg, n_frames, **kwargs),
                   interleaved, dtype)


def write_wideband_capture(path: str, cfg: RadarConfig, n_frames: int,
                           interleaved: bool | None = None,
                           dtype=np.float32, **kwargs) -> None:
    """Write a synthetic wideband capture (wideband_capture_arrays; its
    keyword arguments pass through) in the layout of write_synth_capture,
    HDF5 or, for a ``.zarr`` path, a zarr v2 directory store."""
    _write_capture(path, cfg, *wideband_capture_arrays(cfg, n_frames,
                                                      **kwargs),
                   interleaved, dtype)
