"""The port's native ingest helpers (csrc/pr_io.cc via ctypes), on the CPU.

Mirrors tests/test_native_io.py: the library builds (g++) into the port's
own csrc/build/, never into the JAX package's native/ directory, and its
int16 conversion and channel de-multiplexing are bit-equal to the port's
numpy path and to the JAX package's helpers.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from passiveradar_torch.io import native
from passiveradar_tpu.io import native as j_native

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_LIB = REPO / "native" / "libpr_io.so"
BUILD = REPO / "passiveradar_torch" / "csrc" / "build"


def _stat(path):
    return path.stat().st_mtime_ns if path.exists() else None


def test_builds_into_the_ports_directory(monkeypatch):
    """Every file the build writes lies in the port's csrc/build/; the JAX
    package's library keeps its mtime. (Where it is absent, a JAX test in
    another worker may build it meanwhile, so the written paths are what
    shows that this build never touches it.)"""
    before = _stat(JAX_LIB)
    written = []
    run, replace = subprocess.run, os.replace

    def spy_run(cmd, **kw):
        written.append(cmd[cmd.index("-o") + 1])
        return run(cmd, **kw)

    def spy_replace(src, dst):
        written.append(dst)
        return replace(src, dst)

    monkeypatch.setattr(subprocess, "run", spy_run)
    monkeypatch.setattr(os, "replace", spy_replace)
    path = native.build_library(force=True)
    assert path is not None, "g++ build of csrc/pr_io.cc failed"
    assert pathlib.Path(path) == BUILD / "libpr_io.so"
    assert len(written) == 2 and path in written
    assert all(pathlib.Path(w).parent == BUILD for w in written)
    monkeypatch.undo()
    assert native.build_library() == path
    assert native.library() == path
    if before is not None:
        assert _stat(JAX_LIB) == before


@pytest.mark.parametrize("n", [1000, 4 * 251 + 3])
@pytest.mark.parametrize("scale", [1 / 32768, 0.5, 0.1])
def test_i16_to_f32(n, scale, rng, monkeypatch):
    x = rng.integers(-32768, 32767, n).astype(np.int16)
    got = native.i16_to_f32(x, scale)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, j_native.i16_to_f32(x, scale))
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(got, native.i16_to_f32(x, scale))


@pytest.mark.parametrize("n", [4 * 500, 4 * 301 + 3])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_demux2(n, dtype, rng, monkeypatch):
    if dtype == np.int16:
        raw = rng.integers(-32768, 32767, n).astype(np.int16)
    else:
        raw = rng.standard_normal(n).astype(np.float32)
    ref, srv = native.demux2(raw, scale=0.5)
    assert ref.dtype == srv.dtype == np.complex64
    assert ref.shape == srv.shape == (n // 4,)
    j_ref, j_srv = j_native.demux2(raw, scale=0.5)
    np.testing.assert_array_equal(ref, j_ref)
    np.testing.assert_array_equal(srv, j_srv)
    # the reference's split: deinterleave to complex, then even/odd samples
    q = raw[:n // 4 * 4].astype(np.float32) * np.float32(
        0.5 if dtype == np.int16 else 1.0)
    cplx = (q[0::2] + 1j * q[1::2]).astype(np.complex64)
    np.testing.assert_array_equal(ref, cplx[0::2])
    np.testing.assert_array_equal(srv, cplx[1::2])
    monkeypatch.setattr(native, "_load", lambda: None)
    n_ref, n_srv = native.demux2(raw, scale=0.5)
    np.testing.assert_array_equal(n_ref, ref)
    np.testing.assert_array_equal(n_srv, srv)


def test_concurrent_builds_leave_a_library_that_loads():
    """Two processes forcing a build at once: each gets the path, and the
    library there loads and converts."""
    code = ("import sys; from passiveradar_torch.io import native; "
            "sys.exit(native.build_library(force=True) is None)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                              env=env) for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    check = ("import ctypes, sys; import numpy as np; "
             "from passiveradar_torch.io import native; "
             "lib = ctypes.CDLL(native._LIB); "
             "x = np.arange(-4, 4, dtype=np.int16); "
             "y = np.empty(8, np.float32); "
             "lib.pr_i16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, "
             "ctypes.c_size_t, ctypes.c_float]; "
             "lib.pr_i16_to_f32(x.ctypes.data, y.ctypes.data, 8, 0.5); "
             "sys.exit(not np.array_equal(y, x * np.float32(0.5)))")
    res = subprocess.run([sys.executable, "-c", check], cwd=str(REPO),
                         env=env, timeout=120)
    assert res.returncode == 0
