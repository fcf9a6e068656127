"""Digital down-conversion: frequency shifting with high-precision phase.

Port of the JAX package's ops/mixer.py. The oscillator e^{j2πcn} is an outer
product of two small float64 host tables (n = n1·K + n0), so the per-sample
device work is one complex multiply with ~float32-quantisation phase error
at any chunk length. Per-block starting phases keep block-wise mixing
phase-continuous (reference main.py:122-130).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SPLIT_K = 4096


@functools.lru_cache(maxsize=64)
def _phase_tables(c: float, n: int):
    """Host float64 coarse/fine oscillator tables for e^{j2πc·n}."""
    n1_max = -(-n // _SPLIT_K)
    coarse_cycles = np.mod(c * _SPLIT_K * np.arange(n1_max, dtype=np.float64),
                           1.0)
    fine_cycles = np.mod(c * np.arange(_SPLIT_K, dtype=np.float64), 1.0)
    coarse = np.exp(2j * np.pi * coarse_cycles).astype(np.complex64)
    fine = np.exp(2j * np.pi * fine_cycles).astype(np.complex64)
    return coarse, fine


@functools.cache
def _device_phase_tables(c: float, n: int, device: torch.device):
    """``_phase_tables`` on ``device``, kept (unbounded: a replayed CUDA
    graph reads them by address, ops/graphs.py)."""
    return tuple(torch.from_numpy(t).to(device) for t in _phase_tables(c, n))


@functools.cache
def _scalar_phase(value: float, device: torch.device) -> torch.Tensor:
    """A scalar starting phase as a float32 tensor on ``device``, made
    once: no host copy per call."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def phase_rotor(phase: torch.Tensor) -> torch.Tensor:
    """e^{j·phase} as complex64 from float32 radians."""
    ph = phase.float()
    return torch.complex(torch.cos(ph), torch.sin(ph))


def frequency_shift(x: torch.Tensor, fc: float, fs: float,
                    phase_offset=0.0) -> torch.Tensor:
    """Shift ``x`` (..., N) complex in frequency by ``fc`` at rate ``fs``.

    ``phase_offset`` is a scalar or, for batched (B, N) input, a length-B
    tensor of per-chunk starting phases. Equivalent to the reference's
    ``x * exp(j*2π*fc*n/Fs + j*phase_offset)`` (signal_utils.py:24-27).
    """
    n = x.shape[-1]
    osc_c, osc_f = _device_phase_tables(float(fc) / float(fs), n, x.device)
    osc = (osc_c[:, None] * osc_f[None, :]).reshape(-1)[:n]
    if isinstance(phase_offset, (int, float)):
        ph = _scalar_phase(float(phase_offset), x.device)
    else:
        ph = torch.as_tensor(phase_offset, dtype=torch.float32,
                             device=x.device)
    return x.to(torch.complex64) * osc * phase_rotor(ph)[..., None]


def block_phase_offsets(num_blocks: int, block_len: int, fc: float,
                        fs: float) -> np.ndarray:
    """Per-block starting phases for phase-continuous block-wise mixing.

    Block k starts with phase 2π·k·((block_len mod (fs // fc))·fc/fs),
    reduced mod 2π in float64 host arithmetic (reference main.py:122-130).
    Returns float32 radians of shape (num_blocks,).
    """
    if fc == 0:
        return np.zeros(num_blocks, dtype=np.float32)
    mod_period = int(fs) // int(fc)
    osb = block_len % mod_period
    k = np.arange(num_blocks, dtype=np.float64)
    cycles = np.mod(k * (osb * float(fc) / float(fs)), 1.0)
    return (2.0 * np.pi * cycles).astype(np.float32)
