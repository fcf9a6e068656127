"""Batched complex NLMS clutter canceller: the CUDA kernel and its plain
version.

``nlms_filter_batch`` replaces ``nlms_filter_pallas``, the Pallas TPU kernel
of the JAX package's ``ops/nlms_pallas.py`` (pallas_call at :211, body
``_nlms_kernel`` :38), and takes its arguments (``ref, srv, filter_len, mu,
peek, return_filter``). Per frame, with m = filter_len + peek taps and
steps = n − m, step k computes

    u = ref[k+1 : k+1+m]
    e = srv[k+filter_len] − wᴴu          → out[filter_len + k]
    w ← w + μ·u·conj(e) / g(uᴴu)

and ``out`` is zero outside [filter_len, filter_len+steps). ``zero_window``
picks g: ``"zero"`` is max(uᴴu, 1e-30), the TPU kernel's guard (an
all-zero window leaves the taps as they are); ``"nan"`` is the plain
division of the JAX ``nlms_filter`` scan (an all-zero window turns the taps,
and every later error, into NaN). ``initial_taps`` (the scan's warm start)
and the returned taps are in the reference orientation, flipped against w
above, as both JAX functions keep them; with ``initial_taps`` the filter
length is its length less ``peek``, as in the scan. The TPU kernel's
``block`` (a VMEM tiling knob) and ``interpret`` (a Pallas switch) have no
counterpart here.

Kernel (``csrc/nlms.cu``, CUDA C++ for sm_90a, built by
``ops/cuda_build.py`` and bound with ctypes): the exact block form of the
recurrence. Over a block of P steps the errors solve (I + L) e = c, L
built from ref alone (the block's Gram u_iᴴu_j and step sizes). While the
card holds a launch's clusters at once, each frame takes a thread-block
cluster of two CTAs: a producer forms M = (I + L)⁻¹ ahead and hands it to
the chain's CTA through distributed shared memory; there all warps take
the P dot products c = d − w₀ᴴu_j, one warp takes e = M c as a dense
product, and all warps apply the rank-P tap update. Past that
(``cluster_ctas``), a second kernel takes one CTA a frame, whose warp 0
solves each block step by step while its other warps build the Gram. Its
note says what bounds it and how zero windows are kept exact. On a CPU
tensor the wrapper runs ``nlms_filter_batch_plain``, a loop over the steps
vectorised over frames, in complex64; on a CUDA tensor it always launches
the kernel, on the tensor's card, and raises if the build or the launch
fails. ``nlms_filter_batch.launches`` counts kernel launches and
``nlms_filter_batch.frames`` the frames they filtered.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passiveradar_torch.ops import cuda_build

MAX_TAPS = 512       # m = filter_len + peek: 2 taps a thread in the update
ZERO_WINDOWS = ("zero", "nan")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a library built from ``csrc/nlms.cu``."""
    lib.nlms_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.nlms_launch.restype = ctypes.c_int
    lib.nlms_cluster_ctas.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.nlms_cluster_ctas.restype = ctypes.c_int
    lib.nlms_block_steps.argtypes = []
    lib.nlms_block_steps.restype = ctypes.c_int
    lib.nlms_error_string.argtypes = [ctypes.c_int]
    lib.nlms_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("nlms"))


def cluster_ctas(frames: int, device=None) -> int:
    """The CTAs a frame of a kernel launch of ``frames`` frames on
    ``device`` (a CUDA device; the current one if None): 2 (the chain and
    a producer) while the card holds every frame's cluster at once, else 1
    (the kernel that solves each block itself)."""
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    lib = _library()
    ctas = ctypes.c_int()
    err = lib.nlms_cluster_ctas(frames, index, ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError("nlms cluster query failed: "
                           + lib.nlms_error_string(err).decode())
    return ctas.value


def _prepare(ref, srv, filter_len, peek, initial_taps, zero_window):
    """Checks and shapes shared by both versions: (B, n) complex64 ref and
    srv, the initial taps as (B, m) in the kernel's unflipped order (or
    None), the filter length, m, and whether the input was 1-D."""
    if zero_window not in ZERO_WINDOWS:
        raise ValueError(f"zero_window must be one of {ZERO_WINDOWS}, got "
                         f"{zero_window!r}")
    squeeze = ref.dim() == 1
    if squeeze:
        ref, srv = ref[None], srv[None]
    if ref.dim() != 2 or ref.shape != srv.shape:
        raise ValueError(f"ref and srv must be (n,) or (B, n) of one shape, "
                         f"got {tuple(ref.shape)} and {tuple(srv.shape)}")
    if ref.device != srv.device:
        raise ValueError("ref and srv must be on the same device")
    ref = ref.to(torch.complex64).contiguous()
    srv = srv.to(torch.complex64).contiguous()
    b, n = ref.shape
    w0 = None
    if initial_taps is not None:
        w0 = torch.as_tensor(initial_taps).to(device=ref.device,
                                              dtype=torch.complex64)
        if w0.dim() not in (1, 2) or (w0.dim() == 2 and w0.shape[0] != b):
            raise ValueError(f"initial_taps must be (m,) or ({b}, m), got "
                             f"{tuple(w0.shape)}")
        filter_len = w0.shape[-1] - peek
        w0 = w0.flip(-1).expand(b, -1).contiguous()
    m = filter_len + peek
    if filter_len < 1 or peek < 0 or n <= m:
        raise ValueError(f"need filter_len >= 1, peek >= 0 and n > "
                         f"filter_len + peek, got filter_len={filter_len}, "
                         f"peek={peek}, n={n}")
    return ref, srv, w0, filter_len, m, squeeze


def _finish(out, w, squeeze, return_filter):
    """Drop the batch axis of a 1-D call; taps back to the reference
    orientation."""
    if not return_filter:
        return out[0] if squeeze else out
    taps = w.flip(-1)
    return (out[0], taps[0]) if squeeze else (out, taps)


def nlms_filter_batch_plain(ref: torch.Tensor, srv: torch.Tensor,
                            filter_len: int, mu: float, peek: int = 10,
                            return_filter: bool = False, initial_taps=None,
                            zero_window: str = "zero"):
    """The plain torch version of the kernel (same signature and result): a
    loop over the steps, each one complex dot product and one tap update
    for all frames at once. uᴴu is summed per window, as in the kernel."""
    ref, srv, w, filter_len, m, squeeze = _prepare(
        ref, srv, filter_len, peek, initial_taps, zero_window)
    b, n = ref.shape
    steps = n - m
    if w is None:
        w = torch.zeros((b, m), dtype=torch.complex64, device=ref.device)
    windows = ref[:, 1:].unfold(-1, m, 1)                  # (B, steps, m)
    power = ref.real ** 2 + ref.imag ** 2
    uu = power[:, 1:].unfold(-1, m, 1).sum(-1)             # (B, steps)
    if zero_window == "zero":
        uu = uu.clamp_min(1e-30)
    scale = mu / uu
    d = srv[:, filter_len:filter_len + steps]
    err = torch.empty((b, steps), dtype=torch.complex64, device=ref.device)
    for k in range(steps):
        u = windows[:, k]
        e = d[:, k] - torch.linalg.vecdot(w, u)           # Σ conj(w)·u
        err[:, k] = e
        w = w + u * (e.conj() * scale[:, k]).unsqueeze(-1)
    out = torch.zeros((b, n), dtype=torch.complex64, device=ref.device)
    out[:, filter_len:filter_len + steps] = err
    return _finish(out, w, squeeze, return_filter)


def nlms_filter_batch(ref: torch.Tensor, srv: torch.Tensor, filter_len: int,
                      mu: float, peek: int = 10, return_filter: bool = False,
                      initial_taps=None, zero_window: str = "zero"):
    """Batched NLMS (see the module docstring). ref/srv: (B, n) or (n,)
    complex64 → out of the same shape, plus the (B, m) or (m,) taps in the
    reference orientation when ``return_filter``. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if ref.device.type != "cuda":
        return nlms_filter_batch_plain(ref, srv, filter_len, mu, peek,
                                       return_filter, initial_taps,
                                       zero_window)
    ref, srv, w0, filter_len, m, squeeze = _prepare(
        ref, srv, filter_len, peek, initial_taps, zero_window)
    if m > MAX_TAPS:
        raise ValueError(f"filter_len + peek = {m} taps: the kernel holds at "
                         f"most {MAX_TAPS}")
    b, n = ref.shape
    out = torch.empty((b, n), dtype=torch.complex64, device=ref.device)
    w = torch.empty((b, m), dtype=torch.complex64, device=ref.device) \
        if return_filter else None
    lib = _library()
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = lib.nlms_launch(ref.data_ptr(), srv.data_ptr(),
                          None if w0 is None else w0.data_ptr(),
                          out.data_ptr(), None if w is None else w.data_ptr(),
                          b, n, filter_len, m, float(mu),
                          int(zero_window == "nan"), ref.get_device(),
                          stream)
    if err != 0:
        raise RuntimeError("nlms kernel launch failed: "
                           + lib.nlms_error_string(err).decode())
    nlms_filter_batch.launches += 1
    nlms_filter_batch.frames += b
    return _finish(out, w, squeeze, return_filter)


nlms_filter_batch.launches = 0
nlms_filter_batch.frames = 0
