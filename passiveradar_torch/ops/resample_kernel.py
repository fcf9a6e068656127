"""Polyphase regroup + complex matmul of the mix-resampler: the CUDA kernel.

Replaces ``mix_regroup_matmul``, the Pallas TPU kernel of the JAX package's
``ops/resample_pallas.py`` (pallas_call at :232, body ``_kernel_cx`` :135).
Same contract:

    o[f, g, p] = Σ_{c < W} x[f, g·down + c − pad_left] · B̃[p, c]

for the complex input x (zero outside [0, n)) and the oscillator-folded
complex tap bank B̃ (``bank`` = [Re B̃; Im B̃], shape (2·up, W), from
``ops/fir.py:_mix_resample_static``), returned as (o_re, o_im), each
(F, groups, up) float32.

Kernel (``csrc/mix_regroup.cu``, CUDA C++ for sm_90a, built by
``ops/cuda_build.py`` and bound with ctypes):
one CTA per (frame, tile of 64 consecutive groups). The CTA stages its
contiguous input span [g0·down − pad_left, (g0+64−1)·down + W − pad_left)
straight from the interleaved (F, n, 2) tensor into shared memory with
cp.async, zero-filling outside [0, n) — so neither the left pad nor the
right pad is ever materialised in device memory — and the bank beside it,
in the layout of ``pack_bank``: (W, up rounded to even) complex pairs, with
the all-zero trailing columns of the slab-rounded TPU bank cut off. Each
thread owns one group and all ``up`` phases, accumulating Σ x·B̃ with FP32
FMAs (no TF32); the contraction is split over two thread halves and summed
through shared memory. The ragged last tile is masked.

What bounds it (FM geometry, one channel batch: F = 10, n = 2,399,625,
up/down = 13/119, groups = 20,171): ~192 MB in + 21 MB out, 0.064 ms at
3.35 TB/s. The bank holds 2,381 nonzero taps (each phase ~183 of the 294
columns the kernel keeps), so the work that is needed is
10·20,171·2,381 complex MACs = 3.8 GFLOP, 0.057 ms at the H100 SXM's
67 TFLOP/s FP32: memory bounds it. The kernel runs every (phase, column)
pair, zeros included (13·294 per group).

On a CPU tensor the wrapper runs ``mix_regroup_matmul_plain`` (the same
function in torch ops); on a CUDA tensor it always launches the kernel and
raises if the build or the launch fails. ``mix_regroup_matmul.launches``
counts kernel launches. Both return one (F, groups, up) complex64 tensor:
o_re and o_im of the TPU kernel are its real and imaginary parts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passiveradar_torch.ops import cuda_build

MAX_UP = 20          # derive_config limits the resampling denominator to 20


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mix_regroup")
    lib.mix_regroup_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.mix_regroup_launch.restype = ctypes.c_int
    lib.mix_regroup_error_string.argtypes = [ctypes.c_int]
    lib.mix_regroup_error_string.restype = ctypes.c_char_p
    return lib


def pack_bank(bank: torch.Tensor, up: int) -> torch.Tensor:
    """(2·up, W) [Re B̃; Im B̃] bank → (W', up rounded to even, 2) float32
    complex pairs, the layout of both versions (the kernel loads two phases
    with one float4). W' drops the trailing columns that are zero in every
    phase, which leaves the result unchanged. Pack once per bank."""
    if bank.dim() != 2 or bank.shape[0] != 2 * up or \
            bank.dtype != torch.float32:
        raise ValueError(f"bank must be (2*up, W) float32, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    used = torch.nonzero((bank != 0).any(0))
    w = int(used[-1]) + 1 if used.numel() else 1
    bt = torch.zeros((w, up + (up & 1), 2), dtype=torch.float32,
                     device=bank.device)
    bt[:, :up, 0] = bank[:up, :w].T
    bt[:, :up, 1] = bank[up:, :w].T
    return bt


def _check(x: torch.Tensor, bank: torch.Tensor, up: int):
    if x.dim() != 3 or x.shape[2] != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (F, n, 2) float32 IQ pairs, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if bank.dim() != 3 or bank.shape[1:] != (up + (up & 1), 2) or \
            bank.dtype != torch.float32 or not bank.is_contiguous():
        raise ValueError(f"bank must be pack_bank's (W, up rounded to even, "
                         f"2) float32, got {tuple(bank.shape)} {bank.dtype}")
    if bank.device != x.device:
        raise ValueError("x and bank must be on the same device")


def mix_regroup_matmul_plain(x: torch.Tensor, bank: torch.Tensor, down: int,
                             groups: int, up: int, pad_left: int = 0):
    """The plain torch version of the kernel (same signature and result):
    strided windows of the zero-padded complex input, then one complex
    matmul with the bank."""
    _check(x, bank, up)
    f, n, _ = x.shape
    w = bank.shape[0]
    total = (groups - 1) * down + w
    xc = torch.view_as_complex(x.contiguous())
    xp = torch.nn.functional.pad(xc, (pad_left, max(0, total - n - pad_left)))
    win = xp[:, :total].unfold(-1, w, down)                # (F, groups, W)
    return torch.matmul(win, torch.view_as_complex(bank)[:, :up])


def mix_regroup_matmul(x: torch.Tensor, bank: torch.Tensor, down: int,
                       groups: int, up: int, pad_left: int = 0):
    """Polyphase regroup + complex matmul (see the module docstring).

    x: (F, n, 2) float32 interleaved IQ; bank: ``pack_bank(bank_ri, up)``.
    Returns (F, groups, up) complex64. CUDA tensors launch the kernel; CPU
    tensors take the plain version.
    """
    if x.device.type != "cuda":
        return mix_regroup_matmul_plain(x, bank, down, groups, up, pad_left)
    _check(x, bank, up)
    if not 1 <= up <= MAX_UP:
        raise ValueError(f"up={up} outside the kernel's 1..{MAX_UP}")
    x = x.contiguous()
    f, n, _ = x.shape
    out = torch.empty((f, groups, up), dtype=torch.complex64, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mix_regroup_launch(x.data_ptr(), bank.data_ptr(), out.data_ptr(),
                                 f, n, bank.shape[0], down, groups, up,
                                 pad_left, x.get_device(), stream)
    if err != 0:
        raise RuntimeError("mix_regroup kernel launch failed: "
                           + lib.mix_regroup_error_string(err).decode())
    mix_regroup_matmul.launches += 1
    return out


mix_regroup_matmul.launches = 0
