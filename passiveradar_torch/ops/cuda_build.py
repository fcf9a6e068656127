"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface, ``csrc/build/lib<name>.so``, and bound with ctypes. A
library is built at first use, or again when its source is newer; ``build``
starts every nvcc it needs at once and waits for all of them, so building
the whole set takes as long as the slowest source. A variant is a source
built with preprocessor defines into a library of its own,
``lib<name>-<DEFINE><value>.so``, for measurements that compare builds.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("mix_regroup", "nlms", "fft_fused", "tracker", "levinson")
# nvcc flags of one source beyond the common ones: the tracker step's gates
# must round as the plain version's separate products and sums do
FLAGS = {"tracker": ("-fmad=false",)}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _stem(name: str, defines=None) -> str:
    return name + "".join(f"-{k}{v}"
                          for k, v in sorted((defines or {}).items()))


def library_path(name: str, defines=None) -> str:
    return os.path.join(BUILD_DIR, f"lib{_stem(name, defines)}.so")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels of passiveradar_torch/csrc")


def _up_to_date(name: str) -> bool:
    lib = library_path(name)
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(source_path(name)))


def build(names=SOURCES, force: bool = False, variants=()) -> dict:
    """Compile the named sources, and the ``variants`` ((name, {define:
    value}) pairs), for sm_90a, all nvcc processes at once.

    Returns {stem: {"path", "seconds", "log"}}, the stem being the name or
    ``<name>-<DEFINE><value>``; ``log`` holds ptxas' register, spill and
    shared-memory report. Raises RuntimeError naming every source that
    failed to compile.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    jobs, result = {}, {}
    for name, defines in [(n, None) for n in names] + list(variants):
        stem, lib = _stem(name, defines), library_path(name, defines)
        if not force and defines is None and _up_to_date(name):
            result[stem] = dict(path=lib, seconds=0.0, log="(up to date)")
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *FLAGS.get(name, ()), "-o", tmp,
               source_path(name)]
        cmd[1:1] = [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[stem] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for stem, (proc, tmp, lib, t0) in jobs.items():
        _, err = proc.communicate()
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            os.remove(tmp)
            failed.append(f"{stem} (nvcc {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)
        result[stem] = dict(path=lib, seconds=dt, log=err)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first when it is missing or
    older than its source. The caller declares argtypes and restype."""
    return ctypes.CDLL(build((name,))[name]["path"])
