"""numpy versions of the ingest helpers (counterpart of
the JAX package's io/native.py; its g++ helper native/pr_io.cc is not part of
the port yet)."""

from __future__ import annotations

import numpy as np


def i16_to_f32(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """int16 stream → float32 times ``scale``."""
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    np.multiply(x, scale, out=out, casting="unsafe")
    return out


def demux2(x: np.ndarray, scale: float = 1.0):
    """[refI, refQ, srvI, srvQ, ...] stream → (ref, srv) complex64 arrays
    (reference main.py:59-65). Accepts float32 or int16 input."""
    n_pairs = x.size // 4
    if x.dtype == np.int16:
        xf = x[:4 * n_pairs].astype(np.float32) * np.float32(scale)
    else:
        xf = np.asarray(x[:4 * n_pairs], np.float32)
    quads = xf.reshape(n_pairs, 4)
    ref = quads[:, :2].reshape(-1).copy()
    srv = quads[:, 2:].reshape(-1).copy()
    return ref.view(np.complex64), srv.view(np.complex64)
