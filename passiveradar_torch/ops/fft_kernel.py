"""Fused four-step FFT: the CUDA kernel and its plain version.

``fft_fused`` replaces the Pallas TPU kernel of the JAX package's
``ops/fft_pallas.py`` (``_fft_fused_planes``, pallas_call at :127, body
``_kernel`` :81, wrapper ``fft_fused`` :147) and keeps the wrapper's
contract: the DFT along the last axis of x, whose length N is one of the
split table's (2^14 … 2^18), computed as one four-step

    x.reshape(R, C)                          n = c + C·r  (c fast)
    A[k1, c] = Σ_r W_R^{r·k1} · x[r, c]      (R-point DFT down each column)
    Z[k1, c] = A[k1, c] · W_N^{k1·c}         (twiddle)
    Y[k1, k2] = Σ_c Z[k1, c] · W_C^{c·k2}    (C-point DFT along each row)
    out[k1 + R·k2] = Y[k1, k2]               (transposed store)

with (R, C) from ``_SPLITS``; the inverse uses the conjugate exponents and
the exact 1/N. Leading dims flatten into the batch, real input is taken as
complex and an unsupported length raises ``ValueError``. The tables are
float64 with reduced angles ((k·c mod N)/N before the exponential), so the
cast to float32 is their only rounding.

Kernel (``csrc/fft_fused.cu``, CUDA C++ for sm_90a, built by
``ops/cuda_build.py`` and bound with ctypes): two passes over device memory,
the column DFTs with the twiddle, then the row DFTs with the transposed
store, each FFT three Stockham stages of radix 8, 8 and L/64 with the
samples in registers and one shared buffer for the exchanges; its note says
what bounds it. On a CPU tensor the wrapper runs ``fft_fused_reference``,
the four-step above as two complex64 matrix products (full f32); on a CUDA
tensor it always launches the kernel and raises if the build or the launch
fails. ``fft_fused.launches`` counts wrapper calls that launched it.

``use_fused`` reads ``PASSIVERADAR_PALLAS_FFT`` at call time, as the JAX
package does: ``ops/fft.py`` routes its full-length transforms here when it
is set and the length is in the table. Off by default.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from passiveradar_torch.ops import cuda_build

# N -> (R, C): the JAX kernel's split table
_SPLITS = {
    16384: (128, 128),
    32768: (128, 256),
    65536: (256, 256),
    131072: (256, 512),
    262144: (512, 512),
}


def supported(n: int) -> bool:
    return n in _SPLITS


def use_fused() -> bool:
    """Route ops/fft.py's full-length transforms through the kernel?
    Opt in with ``PASSIVERADAR_PALLAS_FFT=1``; unset, "0", "" and "false"
    mean off. Read at every call."""
    env = os.environ.get("PASSIVERADAR_PALLAS_FFT")
    return env is not None and env not in ("0", "", "false")


def _exp(num: np.ndarray, den: int, inverse: bool) -> np.ndarray:
    """exp(∓2πi·(num mod den)/den) in float64, cast to complex64."""
    sgn = 2j if inverse else -2j
    return np.exp(sgn * np.pi * ((num % den) / den)).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _tables(n: int, inverse: bool):
    """(D_R (R, R), D_C (C, C), twiddle (R, C)) complex64 host tables of
    the four-step; the inverse's 1/n rides D_C (a power of two, exact)."""
    r, c = _SPLITS[n]

    def dmat(m):
        k = np.arange(m, dtype=np.float64)
        return _exp(np.outer(k, k), m, inverse)

    k1 = np.arange(r, dtype=np.float64)[:, None]
    cc = np.arange(c, dtype=np.float64)[None, :]
    dc = dmat(c)
    if inverse:
        dc = dc * np.float32(1.0 / n)
    return dmat(r), dc, _exp(k1 * cc, n, inverse)


@functools.lru_cache(maxsize=32)
def _device_tables(n: int, inverse: bool, device: torch.device):
    return tuple(torch.from_numpy(t).to(device) for t in _tables(n, inverse))


def _stage_twiddles(length: int) -> np.ndarray:
    """The butterfly twiddles of the kernel's ``length``-point FFT (128, 256
    or 512: Stockham stages of radix 8, 8 and length/64): W_64^(r·k) for
    r = 1..7, k < 8, then W_length^(r·b) for r = 1..length/64 - 1, b < 64,
    complex64 from the float64 reduced angles of ``_exp``. The kernel runs
    the inverse as conj ∘ forward ∘ conj, so these are forward twiddles."""
    r, k = np.meshgrid(np.arange(1, 8), np.arange(8), indexing="ij")
    rb, b = np.meshgrid(np.arange(1, length // 64), np.arange(64),
                        indexing="ij")
    return np.concatenate([_exp(r * k, 64, False).ravel(),
                           _exp(rb * b, length, False).ravel()])


def _kernel_tables(n: int, device: torch.device):
    """The kernel's tables on ``device``: the stage twiddles of the R- and
    the C-point FFT of n's split (``_stage_twiddles``)."""
    return tuple(torch.from_numpy(_stage_twiddles(m)).to(device)
                 for m in _SPLITS[n])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fft_fused")
    lib.fft_fused_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fft_fused_launch.restype = ctypes.c_int
    lib.fft_fused_error_string.argtypes = [ctypes.c_int]
    lib.fft_fused_error_string.restype = ctypes.c_char_p
    return lib


def _prepare(x: torch.Tensor):
    n = x.shape[-1]
    if not supported(n):
        raise ValueError(f"fft_fused: unsupported length {n}")
    if not x.is_complex():
        x = x.float()
    return x.to(torch.complex64), n


def fft_fused_reference(x: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """The plain four-step (same contract as ``fft_fused``): the column
    DFT and the row DFT as complex64 matrix products with the tables of
    ``_tables``, the twiddle between them, then the transpose."""
    x, n = _prepare(x)
    r, c = _SPLITS[n]
    lead = x.shape[:-1]
    dr, dc, tw = _device_tables(n, inverse, x.device)
    a = torch.matmul(dr, x.reshape(-1, r, c))      # D_R is symmetric
    y = torch.matmul(a * tw, dc)                   # (B, k1, k2)
    return y.transpose(-1, -2).reshape(lead + (n,))


@functools.cache
def _device_state(n: int, index: int) -> tuple:
    """What a launch at length n on card ``index`` needs besides x: the
    split, the tables' addresses, the bound entry point, and the tables
    themselves (held here so that their addresses stay valid, also for the
    CUDA graphs of ops/graphs.py that replay a launch)."""
    tw_r, tw_c = _kernel_tables(n, torch.device("cuda", index))
    return (*_SPLITS[n], tw_r.data_ptr(), tw_c.data_ptr(),
            _library().fft_fused_launch, (tw_r, tw_c))


def fft_fused(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """DFT along the last axis (see the module docstring). x: (..., N)
    complex64 or real, N in the split table → (..., N) complex64. CUDA
    tensors launch the kernel; CPU tensors take the plain version. The
    checks are cheap on purpose: the stream's transforms are small enough
    for the host's enqueue time to matter."""
    if not x.is_cuda:
        return fft_fused_reference(x, inverse)
    if x.dtype != torch.complex64:
        x, _ = _prepare(x)
    n = x.shape[-1]
    if n not in _SPLITS:
        raise ValueError(f"fft_fused: unsupported length {n}")
    if not x.is_contiguous() or x.data_ptr() % 16:    # 16 bytes a thread
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    index = x.get_device()
    r, c, tw_r, tw_c, launch, _ = _device_state(n, index)
    scratch = torch.empty_like(x)
    err = launch(x.data_ptr(), scratch.data_ptr(), out.data_ptr(), tw_r, tw_c,
                 x.numel() // n, r, c, inverse, index,
                 torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError("fft_fused kernel launch failed: "
                           + _library().fft_fused_error_string(err).decode())
    fft_fused.launches += 1
    return out


fft_fused.launches = 0
