"""ctypes bindings for the native ingest helpers (``csrc/pr_io.cc``).

The shared library is built on demand with g++ into ``csrc/build/`` (the
directory of the CUDA kernels' builds), again when the source is newer;
every helper has a numpy path, bit-equal to the library's, used where the
library cannot be built or loaded. This is host code: the helpers convert
and de-multiplex samples read from disk before they go to the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from passiveradar_torch.ops.cuda_build import BUILD_DIR, CSRC

_SRC = os.path.join(CSRC, "pr_io.cc")
_LIB = os.path.join(BUILD_DIR, "libpr_io.so")

_lock = threading.Lock()
_state: dict = {}      # "lib", "path" once the first load was tried


def build_library(force: bool = False) -> str | None:
    """Compile csrc/pr_io.cc → csrc/build/libpr_io.so (g++ -O3
    -march=native) unless an up-to-date build is there. Returns the path,
    or None when g++ is missing or fails.

    The compiler writes a temporary file that replaces the library in one
    rename, so processes that build at once never load a partial file."""
    if not force and os.path.exists(_LIB) and (
            os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError:                     # e.g. a read-only installation
        return None
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return _LIB
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _load():
    """The bound library, or None; built and loaded once a process."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        path, lib = build_library(), None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                path = None
        if lib is not None:
            ptr, size = ctypes.c_void_p, ctypes.c_size_t
            lib.pr_i16_to_f32.argtypes = [ptr, ptr, size, ctypes.c_float]
            lib.pr_f32_demux2.argtypes = [ptr, ptr, ptr, size]
            lib.pr_i16_demux2.argtypes = [ptr, ptr, ptr, size, ctypes.c_float]
            for fn in (lib.pr_i16_to_f32, lib.pr_f32_demux2,
                       lib.pr_i16_demux2):
                fn.restype = None
        _state.update(lib=lib, path=path)
        return lib


def library() -> str | None:
    """The path of the loaded native library (building and loading it on
    first use), or None when the helpers run on numpy."""
    _load()
    return _state["path"]


def i16_to_f32(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """int16 stream → float32 times ``scale`` (rounded to float32 first,
    as the library multiplies in float32)."""
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    lib = _load()
    if lib is not None:
        lib.pr_i16_to_f32(x.ctypes.data, out.ctypes.data, x.size,
                          ctypes.c_float(scale))
    else:
        np.multiply(x, np.float32(scale), out=out)
    return out


def demux2(x: np.ndarray, scale: float = 1.0):
    """[refI, refQ, srvI, srvQ, ...] stream → (ref, srv) complex64 arrays
    (reference main.py:59-65). Accepts float32 or int16 input (int16 times
    ``scale``); a trailing partial quadruple is dropped."""
    n_pairs = x.size // 4
    ref = np.empty(2 * n_pairs, np.float32)
    srv = np.empty(2 * n_pairs, np.float32)
    lib = _load()
    if x.dtype == np.int16:
        x = np.ascontiguousarray(x.reshape(-1)[:4 * n_pairs])
        if lib is not None:
            lib.pr_i16_demux2(x.ctypes.data, ref.ctypes.data, srv.ctypes.data,
                              n_pairs, ctypes.c_float(scale))
            return ref.view(np.complex64), srv.view(np.complex64)
        x = i16_to_f32(x, scale)
    else:
        x = np.ascontiguousarray(x.reshape(-1)[:4 * n_pairs], np.float32)
        if lib is not None:
            lib.pr_f32_demux2(x.ctypes.data, ref.ctypes.data, srv.ctypes.data,
                              n_pairs)
            return ref.view(np.complex64), srv.view(np.complex64)
    quads = x.reshape(n_pairs, 4)
    ref[:] = quads[:, :2].reshape(-1)
    srv[:] = quads[:, 2:].reshape(-1)
    return ref.view(np.complex64), srv.view(np.complex64)
