"""Kalman filtering for radar target tracks (counterpart of the JAX
package's detect/kalman.py).

Float32 re-implementation of the reference's structured-dtype Kalman
machinery (target_detection.py:9-148). The filter state is a dict of float32
tensors on the maps' device; a track table stacks the same dict along a
leading slot axis.

The two-transition-model quirk is deliberate and preserved: the state vector
advances with F1 (which couples range-rate to Doppler) while the covariance
advances with F2 (reference target_detection.py:40-42, 375-382).
"""

from __future__ import annotations

import numpy as np
import torch

# Default filter matrices (reference target_detection.py:375-382)
F1_DEFAULT = np.array([[1, 0, -0.003, 0], [0, 0, -0.003, -0.003],
                       [0, 0, 1, 1], [0, 0, 0, 1]], np.float32)
F2_DEFAULT = np.array([[1, 1, 0, 0], [0, 1, 0, 0],
                       [0, 0, 1, 1], [0, 0, 0, 1]], np.float32)
H_DEFAULT = np.array([[1, 0, 0, 0], [0, 0, 1, 0]], np.float32)
_CONSTANTS = dict(
    P=np.diag([5.0, 0.0225, 0.04, 0.1]).astype(np.float32),
    F1=F1_DEFAULT,
    F2=F2_DEFAULT,
    Q=np.diag([4.0, 0.03, 0.2, 0.08]).astype(np.float32),
    H=H_DEFAULT,
    R=np.diag([5.0, 2.0]).astype(np.float32),
    S=np.eye(2, dtype=np.float32),
)


def default_kalman_state(r=0.0, f=0.0, device=None):
    """Fresh track filter state at measurement (r, f) (reference
    initialize_track, target_detection.py:375-382). ``r`` and ``f`` may be
    float32 tensors, whose device the state takes; else ``device``."""
    if torch.is_tensor(r):
        device = r.device
    r = torch.as_tensor(r, dtype=torch.float32, device=device)
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    x = torch.stack([r, torch.zeros_like(r), f, torch.full_like(r, -1.0)])
    st = {k: torch.from_numpy(v).to(r.device) for k, v in _CONSTANTS.items()}
    return dict(x=x, **st)


def _inv2(m: torch.Tensor) -> torch.Tensor:
    """Explicit 2x2 inverse (cheaper and more stable than a general
    solve)."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    return torch.stack([torch.stack([m[1, 1], -m[0, 1]]),
                        torch.stack([-m[1, 0], m[0, 0]])]) / det


def _advance(st, r_scale):
    x = st["F1"] @ st["x"]
    p = st["F2"] @ st["P"] @ st["F2"].T + st["Q"]
    s = st["H"] @ p @ st["H"].T + st["R"] * r_scale
    return x, p, s


def _measurement_update(st, x, p, s, z):
    k = p @ st["H"].T @ _inv2(s)
    y = z - st["H"] @ x
    x = x + k @ y
    p = (torch.eye(4, dtype=p.dtype, device=p.device) - k @ st["H"]) @ p
    return x, p


def kalman_update(measurement, state):
    """Textbook update (reference target_detection.py:19-61)."""
    x, p, s = _advance(state, 1.0)
    x, p = _measurement_update(state, x, p, s, measurement)
    new = dict(state, x=x, P=p, S=s)
    return state["H"] @ x, new


def adaptive_kalman_update(measurement, last_measurement, state):
    """Update with ad-hoc adaptive R scaling by the squared distance between
    consecutive measurements (reference target_detection.py:63-114)."""
    d = measurement - last_measurement
    r_scale = d[0] ** 2 + d[1] ** 2
    x, p, s = _advance(state, r_scale)
    x, p = _measurement_update(state, x, p, s, measurement)
    new = dict(state, x=x, P=p, S=s)
    return state["H"] @ x, new


def kalman_extrapolate(state):
    """Predict-only step for coasting tracks (reference
    target_detection.py:116-148)."""
    x, p, s = _advance(state, 1.0)
    new = dict(state, x=x, P=p, S=s)
    return state["H"] @ x, new
