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
``ops/cuda_build.py`` and bound with ctypes): it takes the bank as
``pack_bank`` lays it out, (up, Wp) complex rows with Wp a multiple of
``CHUNK`` columns, and a table that gives each chunk the range of phases
with a nonzero tap in it; it runs only those (chunk, phase) pairs, split
evenly over a CTA's eight warps. The mixer's banks are real taps times one
phasor a column (B̃[p, c] = B[p, c]·e^{j2πf(c − pad)}); ``pack_bank`` finds
such factors, and the kernel then turns each sample by its column's phasor
once and runs real taps, two FMAs a tap in place of four. Its CTAs are
persistent, two an SM: each stages the bank and the table into shared
memory once and walks over (frame, tile of 64 groups) items, each item's
input span one bulk copy (a span that reaches outside [0, n) is copied with
zero fill, so no pad is materialised) that runs under the other CTA's
FMAs. Each thread accumulates two groups and all ``up`` phases in FP32 (no
TF32); the warps add their partial sums through shared memory. The
source's note gives the details.

What bounds it (FM geometry, one channel batch: F = 10, n = 2,399,625,
up/down = 13/119, groups = 20,171): ~192 MB in + 21 MB out, 0.064 ms at
3.35 TB/s. The bank holds 2,381 nonzero taps, one run of ~183 of the 294
columns a phase; the table's chunks of 8 columns leave 2,472 complex MACs
a group of the 13·294 = 3,822 a dense pass would run. The function needs
3.8 GFLOP (0.057 ms at the H100 SXM's 67 TFLOP/s FP32): memory bounds it.

On a CPU tensor the wrapper runs ``mix_regroup_matmul_plain`` (the same
function in torch ops, dense over the bank); on a CUDA tensor it always
launches the kernel and raises if the build or the launch fails.
``mix_regroup_matmul.launches`` counts kernel launches. Both return one
(F, groups, up) complex64 tensor: o_re and o_im of the TPU kernel are its
real and imaginary parts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from passiveradar_torch.ops import cuda_build

MAX_UP = 20          # derive_config limits the resampling denominator to 20
CHUNK = 8            # columns a chunk of the phase table (csrc MR_CHUNK)
FACTOR_TOL = 1e-6    # pack_bank's factors: max |real·phasor − B̃| / max |B̃|


class PackedBank(NamedTuple):
    """``pack_bank``'s result. ``taps``: (up, Wp, 2) float32, the complex
    bank B̃ row by phase, Wp a multiple of the chunk width; ``phases``:
    (Wp / chunk, 2) int32, for each chunk of columns the first and last
    phase with a nonzero tap there (first > last when there is none);
    ``real`` (up, Wp) float32 and ``phasor`` (Wp, 2) float32, when B̃ is a
    real bank times one unit phasor a column (B̃[p, c] = real[p, c]·
    phasor[c] to FACTOR_TOL of its peak), else None."""
    taps: torch.Tensor
    phases: torch.Tensor
    real: torch.Tensor | None = None
    phasor: torch.Tensor | None = None

    @property
    def chunk(self) -> int:
        return self.taps.shape[1] // self.phases.shape[0]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a library built from ``csrc/mix_regroup.cu``."""
    lib.mix_regroup_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.mix_regroup_launch.restype = ctypes.c_int
    lib.mix_regroup_chunk.argtypes = []
    lib.mix_regroup_chunk.restype = ctypes.c_int
    lib.mix_regroup_last_launch.argtypes = [ctypes.c_void_p]
    lib.mix_regroup_last_launch.restype = None
    lib.mix_regroup_error_string.argtypes = [ctypes.c_int]
    lib.mix_regroup_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("mix_regroup"))


def pack_bank(bank: torch.Tensor, up: int, chunk: int = CHUNK) -> PackedBank:
    """(2·up, W) [Re B̃; Im B̃] bank → ``PackedBank``, the layout of both
    versions. The columns after the last nonzero one are cut, and the rest
    padded with zeros to a multiple of ``chunk``; neither changes the
    result. The phase table is read off the bank itself, so it holds for
    any bank. Pack once per bank."""
    if bank.dim() != 2 or bank.shape[0] != 2 * up or \
            bank.dtype != torch.float32:
        raise ValueError(f"bank must be (2*up, W) float32, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    if chunk < 4 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4 (the "
                         f"kernel reads taps by fours), got {chunk}")
    used = torch.nonzero((bank != 0).any(0))
    w = int(used[-1]) + 1 if used.numel() else 1
    wp = -(-w // chunk) * chunk
    taps = torch.zeros((up, wp, 2), dtype=torch.float32, device=bank.device)
    taps[:, :w, 0] = bank[:up, :w]
    taps[:, :w, 1] = bank[up:, :w]
    nz = (taps != 0).any(-1).reshape(up, wp // chunk, chunk).any(-1)
    p = torch.arange(up, device=bank.device)[:, None]
    first = torch.where(nz, p, up).amin(0)
    last = torch.where(nz, p, -1).amax(0)
    phases = torch.stack([first, last], -1).to(torch.int32).contiguous()
    return PackedBank(taps, phases, *_factor(taps))


def _factor(taps: torch.Tensor):
    """(real, phasor) with taps[p, c] = real[p, c]·phasor[c] to FACTOR_TOL
    of the peak, or (None, None). The mixer's folded banks factor so: B̃ is
    the real polyphase bank times e^{j2πf(c − pad)}, column by column. Each
    column's phasor is that of its largest tap; float64 throughout."""
    tc = torch.complex(taps[..., 0].double(), taps[..., 1].double())
    ref = tc.gather(0, tc.abs().argmax(0, keepdim=True))[0]
    mag = ref.abs()
    phasor = torch.where(mag > 0, ref / torch.where(mag > 0, mag, 1.0), 1.0)
    turned = tc * phasor.conj()
    if turned.imag.abs().max() > FACTOR_TOL * tc.abs().max():
        return None, None
    return (turned.real.float().contiguous(),
            torch.view_as_real(phasor.to(torch.complex64)).contiguous())


def _check(x: torch.Tensor, bank: PackedBank, up: int):
    if x.dim() != 3 or x.shape[2] != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (F, n, 2) float32 IQ pairs, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not isinstance(bank, PackedBank):
        raise ValueError(f"bank must be pack_bank's PackedBank, got "
                         f"{type(bank).__name__}")
    taps, phases = bank.taps, bank.phases
    if taps.dim() != 3 or taps.shape[0] != up or taps.shape[2] != 2 or \
            taps.dtype != torch.float32 or not taps.is_contiguous() or \
            phases.dim() != 2 or phases.shape[1] != 2 or \
            phases.dtype != torch.int32 or not phases.is_contiguous() or \
            phases.shape[0] == 0 or \
            phases.shape[0] * bank.chunk != taps.shape[1]:
        raise ValueError(f"bank must be pack_bank's (up, Wp, 2) float32 taps "
                         f"and (Wp / chunk, 2) int32 phases, got "
                         f"{tuple(taps.shape)} {taps.dtype} and "
                         f"{tuple(phases.shape)} {phases.dtype}")
    real, phasor = bank.real, bank.phasor
    if (real is None) != (phasor is None) or real is not None and (
            real.shape != taps.shape[:2] or real.dtype != torch.float32
            or not real.is_contiguous()
            or phasor.shape != (taps.shape[1], 2)
            or phasor.dtype != torch.float32
            or not phasor.is_contiguous()):
        raise ValueError("bank.real and bank.phasor must be pack_bank's "
                         "(up, Wp) and (Wp, 2) float32 factors, or None")
    if any(t is not None and t.device != x.device for t in bank):
        raise ValueError("x and bank must be on the same device")


def mix_regroup_matmul_plain(x: torch.Tensor, bank: PackedBank, down: int,
                             groups: int, up: int, pad_left: int = 0):
    """The plain torch version of the kernel (same signature and result):
    strided windows of the zero-padded complex input, then one complex
    matmul with the whole bank (the phase table is not used)."""
    _check(x, bank, up)
    f, n, _ = x.shape
    w = bank.taps.shape[1]
    total = (groups - 1) * down + w
    xc = torch.view_as_complex(x.contiguous())
    xp = torch.nn.functional.pad(xc, (pad_left, max(0, total - n - pad_left)))
    win = xp[:, :total].unfold(-1, w, down)                # (F, groups, Wp)
    return torch.matmul(win, torch.view_as_complex(bank.taps).T)


def mix_regroup_matmul(x: torch.Tensor, bank: PackedBank, down: int,
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
    if any(t is not None and t.data_ptr() % 16 for t in bank):
        raise ValueError("the bank's tensors must be 16-byte aligned "
                         "(pack_bank's)")
    x = x.contiguous()
    f, n, _ = x.shape
    out = torch.empty((f, groups, up), dtype=torch.complex64, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fac = bank.real is not None
    err = lib.mix_regroup_launch(
        x.data_ptr(), bank.taps.data_ptr(),
        bank.real.data_ptr() if fac else None,
        bank.phasor.data_ptr() if fac else None, bank.phases.data_ptr(),
        out.data_ptr(), f, n, bank.taps.shape[1], bank.chunk, down, groups,
        up, pad_left, x.get_device(), stream)
    if err != 0:
        raise RuntimeError("mix_regroup kernel launch failed: "
                           + lib.mix_regroup_error_string(err).decode())
    mix_regroup_matmul.launches += 1
    return out


mix_regroup_matmul.launches = 0
