"""The multitarget Kalman tracker, one frame at a time (counterpart of the
streaming part of the JAX package's detect/trackers.py).

The reference tracker (target_detection.py:455-526) is a Python frame loop
over structured numpy records with data-dependent control flow. Here, as in
the JAX package, the association logic is masks and argmax/argmin
selections over a fixed-size candidate table, and the track table is a
dict of (n_tracks, …) tensors on the maps' device. The JAX ``scan`` over
track slots becomes a Python loop over the slots in priority order; the
only host read of a step is that order.

Documented behavioural notes (kept from the JAX package):
  * association gates, priorities and promotion/kill rules match the
    reference, including its quirk that a preliminary track with several
    gated candidates picks the one nearest the *origin* (reference
    target_detection.py:329), and that status rules read the *pre-update*
    measurement history (reference target_detection.py:436-446).
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch.detect.kalman import (
    _inv2,
    adaptive_kalman_update,
    default_kalman_state,
    kalman_extrapolate,
)
from passiveradar_torch.detect.measurements import get_measurements

N_HISTORY = 20


def _select(pred: torch.Tensor, a, b):
    """Elementwise select over (nested) dicts: pred ? a : b (pred a scalar
    bool tensor)."""
    if isinstance(a, dict):
        return {k: _select(pred, a[k], b[k]) for k in a}
    return torch.where(pred, a, b)


# --------------------------------------------------------------------------
# track table
# --------------------------------------------------------------------------

def _seed_history(device) -> torch.Tensor:
    h = np.zeros(N_HISTORY, np.float32)
    h[0] = 1
    h[5:10] = 1  # the reference's optimistic seed (target_detection.py:388-390)
    return torch.from_numpy(h).to(device)


def make_track(measurement=None, device=None):
    """One track record (reference initialize_track,
    target_detection.py:350-396): free (status 0) at the origin without a
    measurement, preliminary (status 1) at a (2,) measurement tensor."""
    if measurement is None:
        m = torch.zeros(2, dtype=torch.float32, device=device)
        status = 0
    else:
        m = torch.as_tensor(measurement, dtype=torch.float32, device=device)
        status = 1
    dev = m.device
    return dict(
        status=torch.tensor(status, dtype=torch.int32, device=dev),
        lifetime=torch.tensor(1, dtype=torch.int32, device=dev),
        measurement=m,
        estimate=m.clone(),
        history=_seed_history(dev),
        kalman=default_kalman_state(m[0], m[1]),
    )


def _stack(tracks):
    """List of track records → one table with a leading slot axis."""
    first = tracks[0]
    return {k: _stack([t[k] for t in tracks]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in tracks]) for k in first}


def _slot(table, i: int):
    return {k: _slot(v, i) if isinstance(v, dict) else v[i]
            for k, v in table.items()}


def _put(table, i: int, track) -> None:
    for k, v in table.items():
        if isinstance(v, dict):
            _put(v, i, track[k])
        else:
            v[i] = track[k]


def _clone(table):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in table.items()}


def init_tracks(n_tracks: int, device=None):
    """A table of ``n_tracks`` free tracks on ``device``."""
    return _stack([make_track(None, device) for _ in range(n_tracks)])


# --------------------------------------------------------------------------
# association (reference associate_measurements, target_detection.py:231-348)
# --------------------------------------------------------------------------

def _associate(track, cand: torch.Tensor, avail: torch.Tensor):
    """Pick a measurement for one track from the shared candidate pool.

    cand: (3, K) strength-sorted [range, doppler, strength]; avail: (K,) bool.
    Returns (measurement(2,), found(bool), new_avail(K,)).
    """
    r, d = cand[0], cand[1]
    status = track["status"]
    lm, le = track["measurement"], track["estimate"]

    gate_prelim = ((r - lm[0]).abs() < 5) & ((d - lm[1]).abs() < 24)
    gate_conf = ((r - le[0]).abs() < 4) & ((d - le[1]).abs() < 20)
    early = torch.where(status == 0, torch.ones_like(gate_prelim),
                        torch.where(status == 1, gate_prelim, gate_conf))
    pool = early & avail

    # Mahalanobis validation gate for confirmed tracks (zᵀS⁻¹z < 6, centred
    # on the last measurement — reference target_detection.py:284-294)
    sinv = _inv2(track["kalman"]["S"])
    zr, zd = lm[0] - r, lm[1] - d
    m2 = zr * (sinv[0, 0] * zr + sinv[0, 1] * zd) \
        + zd * (sinv[1, 0] * zr + sinv[1, 1] * zd)
    gated = torch.where(status == 2, pool & (m2 < 6), pool)

    count = gated.sum()
    found = count > 0

    # strongest = first True in the strength-sorted order
    first_gated = torch.argmax(gated.to(torch.int32))
    # preliminary tracks pick the candidate nearest the origin (quirk kept)
    dist = torch.where(gated, torch.sqrt(r ** 2 + d ** 2),
                       torch.full_like(r, float("inf")))
    nearest = torch.argmin(dist)
    choice = torch.where(status == 1, nearest, first_gated)
    meas = torch.stack([r[choice], d[choice]])

    # pool consumption: free tracks with several candidates remove everything
    # within 10 km / 12 Hz of the chosen one; free tracks with exactly one
    # candidate clear the pool (the reference's all-ones earlyGate); tracked
    # states remove their early gate.
    rm_free_multi = ((r - meas[0]).abs() < 10) & ((d - meas[1]).abs() < 12)
    rm_free = torch.where(count > 1, rm_free_multi, torch.ones_like(early))
    removal = torch.where(status == 0, rm_free, early)
    new_avail = torch.where(found, avail & ~removal, avail)
    return meas, found, new_avail


# --------------------------------------------------------------------------
# per-track update (reference update_track, target_detection.py:398-453)
# --------------------------------------------------------------------------

def _update_track(track, meas: torch.Tensor, found: torch.Tensor):
    est_u, kal_u = adaptive_kalman_update(meas, track["measurement"],
                                          track["kalman"])
    est_e, kal_e = kalman_extrapolate(track["kalman"])
    new_est = torch.where(found, est_u, est_e)
    new_kal = _select(found, kal_u, kal_e)
    new_meas = torch.where(found, meas, track["measurement"])
    new_hist = torch.cat([found.to(torch.float32).reshape(1),
                          track["history"][:-1]])

    # status rules use the pre-update history, as the reference does
    hist, lifetime, status = track["history"], track["lifetime"], \
        track["status"]
    old_enough = lifetime > 4
    s10 = hist[:10].sum()
    s20 = hist.sum()
    prelim_next = torch.where(old_enough & (s10 < 6), 0,
                              torch.where(old_enough & (s10 > 8), 2, 1))
    conf_next = torch.where(old_enough & (s20 < 4), 0, 2)
    new_status = torch.where(status == 1, prelim_next,
                             torch.where(status == 2, conf_next, status))

    return dict(
        status=new_status.to(torch.int32),
        lifetime=lifetime + 1,
        measurement=new_meas,
        estimate=new_est,
        history=new_hist,
        kalman=new_kal,
    )


def _track_transition(track, meas: torch.Tensor, found: torch.Tensor):
    """Full per-slot transition: free tracks initialise on a measurement and
    are otherwise untouched; live tracks run the update/extrapolate path."""
    fresh = make_track(meas)
    updated = _update_track(track, meas, found)
    is_free = track["status"] == 0
    free_next = _select(found, fresh, track)
    return _select(is_free, free_next, updated)


# --------------------------------------------------------------------------
# frame step
# --------------------------------------------------------------------------

def multitarget_step(tracks, frame, frame_extent, n_tracks: int, k_max: int):
    """One tracker update from one CFAR frame (the streaming entry point).
    Returns a new table; ``tracks`` is left as it was."""
    cand, valid = get_measurements(frame, frame_extent, k_max)
    status = tracks["status"]
    # processing priority: confirmed → preliminary → free, stable by
    # index within each class (reference target_detection.py:494-521)
    prio = torch.where(status == 2, 0, torch.where(status == 1, 1, 2))
    slot_ids = torch.arange(n_tracks, device=status.device)
    order = torch.argsort(prio * n_tracks + slot_ids).tolist()
    tracks = _clone(tracks)
    avail = valid
    for i in order:
        tr = _slot(tracks, i)
        meas, found, avail = _associate(tr, cand, avail)
        _put(tracks, i, _track_transition(tr, meas, found))
    return tracks
