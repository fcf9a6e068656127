"""The multitarget tracker's frame step as one CUDA kernel over every
channel, and its plain version.

``multitarget_step_kernel(table, cand, valid, n_tracks)`` advances C
channels' track tables of ``n_tracks`` slots by T frames of candidates:
table leaves (C, n_tracks, …) as ``trackers.init_tracks`` makes them (status
and lifetime int32, the rest float32), ``cand`` (C, T, 3, K) float32 and
``valid`` (C, T, K) bool from ``measurements.get_measurements``. It returns
the tables after each frame, leaves (T, C, n_tracks, …), and leaves its
input as it was. It replaces nothing in Pallas: the JAX package runs the
step (``detect/trackers.py:189`` ``multitarget_step``, its slot loop a
``lax.scan``) as one XLA program, which the port's eager slot loop made
~2,190 launches and one host read a channel and frame.

Kernel (``csrc/tracker.cu``, CUDA C++ for sm_90a, built by
``ops/cuda_build.py`` with ``-fmad=false`` and bound with ctypes): one CTA
a channel, the table and a frame's candidates in shared memory; every
tracked slot's gates at once as bitmasks over the candidates, then the
association chain on one warp over the pool's bitmask (votes and warp
reductions, no block barrier), two slots a warp for the Kalman
transitions; its note says what bounds it. A channel's table, its gates
and masks and a frame's candidates must fit the card's shared memory
(227 KB a block on an H100): at K = 540 candidates (the FM stream) at
most 273 slots, at 10 slots at most K = 16,640, and never K above
32,768; beyond that the wrapper raises ValueError with the limits at the
call's K and N (``shared_memory_limits``). On CPU tensors the wrapper
runs ``trackers.multitarget_step_plain`` (the slot loop, a channel and a frame
at a time); on CUDA tensors it always launches the kernel, on the tensors'
card and current stream, and raises if the build or the launch fails.
``multitarget_step_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passiveradar_torch.ops import cuda_build

N_HISTORY = 20
# the table's leaves in the kernel's record order: (path, trailing shape,
# dtype)
LEAVES = (
    (("status",), (), torch.int32),
    (("lifetime",), (), torch.int32),
    (("measurement",), (2,), torch.float32),
    (("estimate",), (2,), torch.float32),
    (("history",), (N_HISTORY,), torch.float32),
    (("kalman", "x"), (4,), torch.float32),
    (("kalman", "P"), (4, 4), torch.float32),
    (("kalman", "F1"), (4, 4), torch.float32),
    (("kalman", "F2"), (4, 4), torch.float32),
    (("kalman", "Q"), (4, 4), torch.float32),
    (("kalman", "H"), (2, 4), torch.float32),
    (("kalman", "R"), (2, 2), torch.float32),
    (("kalman", "S"), (2, 2), torch.float32),
)
_POINTERS = ctypes.c_void_p * len(LEAVES)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a library built from ``csrc/tracker.cu``."""
    lib.tracker_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.tracker_launch.restype = ctypes.c_int
    lib.tracker_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tracker_smem_bytes.restype = ctypes.c_longlong
    lib.tracker_smem_optin.argtypes = [ctypes.c_int]
    lib.tracker_smem_optin.restype = ctypes.c_int
    lib.tracker_error_string.argtypes = [ctypes.c_int]
    lib.tracker_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("tracker"))


def _leaf(table, path):
    for key in path:
        table = table[key]
    return table


def _record(track) -> torch.Tensor:
    """A track's leaves as one row of 32-bit words, in the kernel's
    order."""
    return torch.cat([_leaf(track, path).reshape(-1).view(torch.int32)
                      for path, _, _ in LEAVES])


@functools.cache
def _fresh(device: torch.device) -> torch.Tensor:
    """The record of a fresh track at (0, 0) (``trackers.make_track``), on
    ``device``: the kernel writes the measurement into it."""
    from passiveradar_torch.detect.trackers import make_track
    return _record(make_track(torch.zeros(2))).to(device)


def _check(table, cand, valid, n_tracks: int):
    """Dtypes, shapes, contiguity and the device of every argument: (C, T,
    K) and the table's leaves in the kernel's order. Raises ValueError."""
    if cand.dtype != torch.float32 or cand.dim() != 4 or cand.shape[2] != 3:
        raise ValueError(f"cand must be (C, T, 3, K) float32, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    c, t, _, k = cand.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (c, t, k):
        raise ValueError(f"valid must be ({c}, {t}, {k}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if min(c, t, k, n_tracks) < 1:
        raise ValueError(f"need at least one channel, frame, candidate and "
                         f"track, got C={c}, T={t}, K={k}, "
                         f"n_tracks={n_tracks}")
    leaves = []
    for path, trail, dtype in LEAVES:
        leaf = _leaf(table, path)
        name = ".".join(path)
        if leaf.dtype != dtype or tuple(leaf.shape) != (c, n_tracks, *trail):
            raise ValueError(f"table leaf {name} must be "
                             f"{(c, n_tracks, *trail)} {dtype}, got "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
        leaves.append(leaf)
    for name, x in [("cand", cand), ("valid", valid)] + [
            (".".join(p), x) for (p, _, _), x in zip(LEAVES, leaves)]:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != cand.device:
            raise ValueError(f"{name} is on {x.device}, cand on "
                             f"{cand.device}")
    return c, t, k, leaves


def _largest(fits, most: int) -> int:
    """The largest n in 1..most with fits(n) (fits monotone), 0 if none."""
    lo, hi = 0, most
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def shared_memory_limits(k: int, n_tracks: int, device: int) -> dict:
    """What a launch for K candidates and n_tracks slots asks of card
    ``device``'s shared memory: its ``bytes`` (-1 for K above 32768), the
    card's opt-in limit a block (``optin_bytes``), and the most tracks at
    this K and the most candidates at this n_tracks that fit."""
    lib = _library()
    most = lib.tracker_smem_optin(device)
    if most < 0:
        raise RuntimeError("tracker kernel: no shared-memory limit for card "
                           f"{device}: " + lib.tracker_error_string(
                               -most).decode())

    def fits(kk, nn):
        return 0 <= lib.tracker_smem_bytes(kk, nn) <= most

    return dict(bytes=lib.tracker_smem_bytes(k, n_tracks), optin_bytes=most,
                most_tracks=_largest(lambda nn: fits(k, nn), most),
                most_k=_largest(lambda kk: fits(kk, n_tracks), 32768))


@functools.cache
def _check_fits(k: int, n_tracks: int, device: int) -> None:
    """Raise ValueError, naming the limits, where K candidates and n_tracks
    slots ask for more shared memory than the card lets a block have."""
    lim = shared_memory_limits(k, n_tracks, device)
    if not 0 <= lim["bytes"] <= lim["optin_bytes"]:
        raise ValueError(
            f"the tracker kernel holds a channel's table and a frame's "
            f"candidates in shared memory: K={k} candidates and "
            f"n_tracks={n_tracks} ask for {lim['bytes']} bytes (-1: K above "
            f"32768), card {device} allows {lim['optin_bytes']}; at K={k} it "
            f"takes at most {lim['most_tracks']} tracks, at "
            f"n_tracks={n_tracks} at most K={lim['most_k']}")


def _empty_history(t: int, leaves, device) -> dict:
    out = {}
    for (path, _, dtype), leaf in zip(LEAVES, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty((t, *leaf.shape), dtype=dtype,
                                     device=device)
    return out


def multitarget_step_kernel(table, cand: torch.Tensor, valid: torch.Tensor,
                            n_tracks: int) -> dict:
    """Advance every channel's table by each of its T frames of candidates
    (see the module docstring). Returns the (T, C, n_tracks, …) history.
    CUDA tensors launch the kernel once; CPU tensors take the plain
    version."""
    c, t, k, leaves = _check(table, cand, valid, n_tracks)
    if cand.device.type != "cuda":
        from passiveradar_torch.detect.trackers import multitarget_step_plain
        return multitarget_step_plain(table, cand, valid, n_tracks)
    _check_fits(k, n_tracks, cand.get_device())
    hist = _empty_history(t, leaves, cand.device)
    outs = [_leaf(hist, path) for path, _, _ in LEAVES]
    lib = _library()
    err = lib.tracker_launch(
        _POINTERS(*[x.data_ptr() for x in leaves]),
        _POINTERS(*[x.data_ptr() for x in outs]),
        cand.data_ptr(), valid.data_ptr(), _fresh(cand.device).data_ptr(),
        c, t, k, n_tracks, cand.get_device(),
        torch.cuda.current_stream(cand.device).cuda_stream)
    if err != 0:
        raise RuntimeError("tracker kernel launch failed: "
                           + lib.tracker_error_string(err).decode())
    multitarget_step_kernel.launches += 1
    return hist


multitarget_step_kernel.launches = 0
