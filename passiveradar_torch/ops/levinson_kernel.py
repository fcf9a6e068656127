"""The Levinson-Durbin recursion of the LS canceller: the CUDA kernel and its
plain version.

``levinson_first_col_kernel(c)`` returns x = T⁻¹e₀ for each Hermitian
Toeplitz T of a batch, from its first column: c (B, m) complex64 → x (B, m)
complex64. Over k = 1 … m−1 the recursion carries the polynomial a, its
reversed conjugate ar (shifted by one sample a step) and the error e:

    κ  = −(Σⱼ a[j]·c[k−j]) / e
    a  ← a + κ·ar
    ar ← shift₁(ar + κ̄·a)
    e  ← e·(1 − |κ|²)

and x = a/e. It replaces nothing in Pallas: the JAX package computes
``levinson_first_col`` (``ops/clutter.py:113``) as a ``lax.scan`` over the
order (:162) that XLA compiles into one while loop, where the port's eager
loop made ~14 small launches a step, ~2,600 a call at FM.

Kernel (``csrc/levinson.cu``, CUDA C++ for sm_90a, built by
``ops/cuda_build.py`` and bound with ctypes): the Schur–Levinson
recursion, which carries the residual correlations u = a∗c and v = ar∗c
beside the polynomials so that κ = −u[k]/e needs no sum; one warp a
system, a and u in registers (in shared memory above m = 512), ar and v in
shared memory; the next κ's two inputs reach every lane through shared
side cells, so a step has no shuffle, only one ``__syncwarp``; its note
says what bounds it. The wrapper
checks dtype, shape and contiguity first, on every device; on a CPU tensor
it then runs ``levinson_first_col_plain`` without loading the library, on a
CUDA tensor it always launches the kernel, on the tensor's card and current
stream, and raises if the build or the launch fails.
``levinson_first_col_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passiveradar_torch.ops import cuda_build

# the largest order a launch takes: one warp's ar, v, a and u in shared
# memory (csrc/levinson.cu MAX_M)
MAX_ORDER = 8192


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a library built from ``csrc/levinson.cu``."""
    lib.levinson_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.levinson_launch.restype = ctypes.c_int
    lib.levinson_max_order.argtypes = []
    lib.levinson_max_order.restype = ctypes.c_int
    lib.levinson_error_string.argtypes = [ctypes.c_int]
    lib.levinson_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("levinson"))


def levinson_first_col_plain(c: torch.Tensor) -> torch.Tensor:
    """First column x = T⁻¹e₀ of each Hermitian Toeplitz T, batched.

    ``c`` (..., m) is the first column of each T. Levinson-Durbin over the
    order: m−1 dependent steps on a (batch, m) state (reference analog:
    scipy.solve_toeplitz, clutter_removal.py:109-160). ``ar`` carries the
    reversed-conjugate polynomial, updated by a one-sample shift.
    """
    batch = c.shape[:-1]
    m = c.shape[-1]
    cb = c.reshape(-1, m)
    nb = cb.shape[0]
    z = torch.zeros((nb, m), dtype=cb.dtype, device=cb.device)
    # cf_pad[:, 2m-1-k+j] = c[k-j] (zero outside 0..m-1)
    cf_pad = torch.cat([z, torch.flip(cb, [-1]), z], dim=-1)
    a = torch.zeros_like(cb)
    a[:, 0] = 1.0
    e = cb[:, 0].real.clone()
    ar = torch.nn.functional.pad(a[:, :-1], (1, 0))
    for k in range(1, m):
        crev = cf_pad[:, 2 * m - 1 - k:3 * m - 1 - k]
        acc = (a * crev).sum(-1)
        kap = -acc / e
        a_new = a + kap[:, None] * ar
        ar = torch.nn.functional.pad((ar + kap.conj()[:, None] * a)[:, :-1],
                                     (1, 0))
        e = e * (1.0 - kap.abs() ** 2)
        a = a_new
    return (a / e[:, None]).reshape(batch + (m,))


def _check(c: torch.Tensor) -> None:
    """The kernel's contract: (B, m) complex64, contiguous, m ≥ 1. Raises
    ValueError."""
    if c.dtype != torch.complex64:
        raise ValueError(f"c must be complex64, got {c.dtype}")
    if c.dim() != 2 or c.shape[1] < 1:
        raise ValueError(f"c must be (B, m) with m >= 1, got "
                         f"{tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError("c must be contiguous")


def levinson_first_col_kernel(c: torch.Tensor) -> torch.Tensor:
    """x = T⁻¹e₀ for each of the B systems (see the module docstring):
    c (B, m) complex64 → (B, m) complex64. CUDA tensors launch the kernel
    once; CPU tensors take the plain version."""
    _check(c)
    if c.device.type != "cuda":
        return levinson_first_col_plain(c)
    b, m = c.shape
    if m > MAX_ORDER:
        raise ValueError(f"order m = {m}: the kernel takes m <= {MAX_ORDER} "
                         "(one warp's ar, v, a and u in shared memory)")
    x = torch.empty((b, m), dtype=torch.complex64, device=c.device)
    lib = _library()
    err = lib.levinson_launch(c.data_ptr(), x.data_ptr(), b, m,
                              c.get_device(),
                              torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError("levinson kernel launch failed: "
                           + lib.levinson_error_string(err).decode())
    levinson_first_col_kernel.launches += 1
    return x


levinson_first_col_kernel.launches = 0
