"""Minimal zarr v2 DirectoryStore arrays (no third-party dependency).

The reference writes its range-Doppler stacks straight to zarr
(reference main.py:216-224). Where the ``zarr`` package is not installed,
this module implements the small slice of the zarr v2 spec the
framework's writers need — a directory per array holding:

  * ``.zarray``  — JSON metadata (zarr_format=2, shape, chunks, dtype,
    compressor, fill_value, order "C", filters null)
  * ``.zattrs``  — JSON user attributes (the resume counter lives here)
  * chunk files named ``i.j.k`` (C-order chunk grid indices)

Arrays written here open bit-identically under the real ``zarr`` package
(and vice versa for arrays within the supported codec set). Supported
codecs: ``null`` (raw), ``zlib`` and ``gzip`` (stdlib zlib). The real
package's default (blosc) is NOT readable here — io/writers.py prefers the
real package whenever it is importable, so this fallback only ever reads
files it (or another zlib/raw writer) produced.

Writes are chunk-aligned or partial; partial chunk writes read-modify-write
the chunk file, so any numpy basic slice assignment works. Missing chunk
files read as ``fill_value`` (zarr semantics), which is what makes the
format natively resumable/partial-output-safe (SURVEY §5.3).
"""

from __future__ import annotations

import itertools
import json
import os
import zlib

import numpy as np

_CODECS = ("null", "zlib", "gzip")


def _dtype_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    s = dt.str
    if s[0] == "|":          # byte-order-free kinds keep the pipe
        return s
    return "<" + s[1:]       # normalise to little-endian (zarr default)


class Attrs(dict):
    """Dict persisted to ``.zattrs`` on every mutation."""

    def __init__(self, path: str, writable: bool):
        self._path = path
        self._writable = writable
        if os.path.exists(path):
            with _builtin_open(path) as f:
                super().__init__(json.load(f))

    def _flush(self):
        if not self._writable:
            raise PermissionError("array opened read-only")
        tmp = self._path + ".tmp"
        with _builtin_open(tmp, "w") as f:
            json.dump(dict(self), f)
        os.replace(tmp, self._path)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._flush()

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self._flush()


class Array:
    """A zarr v2 array over a directory store (subset: basic slicing)."""

    def __init__(self, path: str, meta: dict, writable: bool):
        self.path = path
        self._meta = meta
        self._writable = writable
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        comp = meta.get("compressor")
        self._codec = "null" if comp is None else comp.get("id", "null")
        if self._codec not in _CODECS:
            raise ValueError(
                f"zarr_min: unsupported compressor {self._codec!r} "
                f"(supported: {_CODECS}); install the real zarr package "
                "to read this array")
        fv = meta.get("fill_value", 0)
        self.fill_value = self.dtype.type(0 if fv is None else fv)
        self.attrs = Attrs(os.path.join(path, ".zattrs"), writable)

    # -- chunk IO ----------------------------------------------------------
    def _chunk_file(self, idx) -> str:
        return os.path.join(self.path, ".".join(str(i) for i in idx))

    def _read_chunk(self, idx) -> np.ndarray:
        f = self._chunk_file(idx)
        if not os.path.exists(f):
            return np.full(self.chunks, self.fill_value, self.dtype)
        with _builtin_open(f, "rb") as fh:
            raw = fh.read()
        if self._codec in ("zlib", "gzip"):
            raw = zlib.decompress(raw, 47)  # auto-detect zlib/gzip headers
        return np.frombuffer(raw, self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx, data: np.ndarray):
        raw = np.ascontiguousarray(data, self.dtype).tobytes()
        if self._codec == "zlib":
            raw = zlib.compress(raw, self._meta["compressor"].get("level", 1))
        elif self._codec == "gzip":
            co = zlib.compressobj(
                self._meta["compressor"].get("level", 1), zlib.DEFLATED, 31)
            raw = co.compress(raw) + co.flush()
        tmp = self._chunk_file(idx) + ".tmp"
        with _builtin_open(tmp, "wb") as fh:
            fh.write(raw)
        os.replace(tmp, self._chunk_file(idx))

    # -- slicing -----------------------------------------------------------
    def _normalise(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (len(self.shape) - len(key))
        out = []
        for k, n in zip(key, self.shape):
            if isinstance(k, slice):
                out.append(k.indices(n))
            else:
                k = int(k)
                if k < 0:
                    k += n
                out.append((k, k + 1, 1))
        if any(s != 1 for _, _, s in out):
            raise NotImplementedError("zarr_min supports step-1 slices only")
        return [(a, b) for a, b, _ in out]

    def _chunk_ranges(self, bounds):
        for idx in itertools.product(*[
                range(a // c, -(-b // c) if b > a else a // c)
                for (a, b), c in zip(bounds, self.chunks)]):
            yield idx

    def __getitem__(self, key):
        bounds = self._normalise(key)
        out = np.empty([b - a for a, b in bounds], self.dtype)
        for idx in self._chunk_ranges(bounds):
            ch = self._read_chunk(idx)
            src, dst = [], []
            for (a, b), c, i in zip(bounds, self.chunks, idx):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = ch[tuple(src)]
        return out

    def __setitem__(self, key, value):
        if not self._writable:
            raise PermissionError("array opened read-only")
        bounds = self._normalise(key)
        value = np.broadcast_to(
            np.asarray(value, self.dtype), [b - a for a, b in bounds])
        for idx in self._chunk_ranges(bounds):
            src, dst, whole = [], [], True
            for (a, b), c, i, n in zip(bounds, self.chunks, idx, self.shape):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - a, hi - a))
                whole &= (lo == i * c and hi == min((i + 1) * c, n)
                          and hi - lo == c)
            if whole:
                ch = value[tuple(dst)]
            else:
                ch = self._read_chunk(idx)   # read-modify-write partial
                ch[tuple(src)] = value[tuple(dst)]
            self._write_chunk(idx, ch)

    def __array__(self, dtype=None, copy=None):
        full = self[tuple(slice(0, n) for n in self.shape)]
        return full.astype(dtype) if dtype is not None else full

    def __len__(self):
        return self.shape[0]


_builtin_open = open  # captured before the module-level name is shadowed


def open(path: str, mode: str = "r", shape=None, chunks=None, dtype=None,
         compressor="default", fill_value=0) -> Array:  # noqa: A001
    """Open/create a zarr v2 directory array (subset of ``zarr.open``).

    mode 'r': read existing. 'a': open existing if present else create.
    'w': create, CLEARING any previous array at the path first (chunk
    files, .zattrs, metadata) — matching real zarr's mode-'w' semantics,
    so neither stale chunk data nor a stale resume counter can leak into
    the new array. 'w-': create, failing if an array already exists.
    ``compressor='default'`` means zlib level 1 — compressed output stays
    real-zarr-readable while keeping the writer dependency-free.
    """
    meta_path = os.path.join(path, ".zarray")
    exists = os.path.exists(meta_path)
    if mode == "r" or (mode == "a" and exists):
        if not exists:
            raise FileNotFoundError(meta_path)
        with _builtin_open(meta_path) as f:
            meta = json.load(f)
        return Array(path, meta, writable=(mode != "r"))
    if mode not in ("w", "a", "w-"):
        raise ValueError(f"unsupported mode {mode!r}")
    if mode == "w-" and exists:
        raise FileExistsError(meta_path)
    if shape is None or dtype is None:
        raise ValueError("creating an array requires shape= and dtype=")
    if mode == "w" and os.path.isdir(path):
        # real zarr's mode 'w' clears the store: an interrupted fresh run
        # must never expose the PREVIOUS array's chunks or resume counter
        for name in os.listdir(path):
            f = os.path.join(path, name)
            if os.path.isfile(f):
                os.remove(f)
    chunks = tuple(chunks) if chunks else tuple(shape)
    if compressor == "default":
        compressor = {"id": "zlib", "level": 1}
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": _dtype_str(np.dtype(dtype)),
        "compressor": compressor,
        "fill_value": fill_value,
        "order": "C",
        "filters": None,
    }
    os.makedirs(path, exist_ok=True)
    tmp = meta_path + ".tmp"
    with _builtin_open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    return Array(path, meta, writable=True)
