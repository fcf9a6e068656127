"""Kalman target trackers (counterpart of the JAX package's
detect/trackers.py).

The reference trackers (target_detection.py:455-526, 626-681) are Python
frame loops over structured numpy records with data-dependent control flow.
Here, as in the JAX package, the association logic is masks and
argmax/argmin selections over a fixed-size candidate table, and the track
table is a dict of (n_tracks, …) tensors on the maps' device, or of
(C, n_tracks, …) tensors for C channels advanced together. On the card the
multitarget step (its slot loop a JAX ``scan``) is one launch of the CUDA
kernel of ``detect/tracker_kernel.py`` for every channel and frame, without
a host read; on the CPU it is the plain version, a Python loop over the
slots in priority order. The simple tracker's frame ``scan`` is a Python
loop on the device.

Documented behavioural notes (quirks preserved or deliberately diverged,
as in the JAX package):
  * association gates, priorities and promotion/kill rules match the
    reference, including its quirk that a preliminary track with several
    gated candidates picks the one nearest the *origin* (reference
    target_detection.py:329), and that status rules read the *pre-update*
    measurement history (reference target_detection.py:436-446).
  * the simple tracker's hard-coded "cols 250:260" clutter zeroing (reference
    target_detection.py:673, valid only for the author's 512-bin frames) is
    generalised to ±5 Doppler columns around the centre (``strict=True``
    keeps the literal one).
  * the simple tracker's rectangular gates clamp at frame edges instead of
    inheriting Python's negative-index slicing behavior (``strict=True``
    keeps the slicing, empty gates included).
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.detect.kalman import (
    _inv2,
    adaptive_kalman_update,
    default_kalman_state,
    kalman_extrapolate,
)
from passiveradar_torch.detect.measurements import get_measurements
from passiveradar_torch.detect.tracker_kernel import N_HISTORY, \
    multitarget_step_kernel


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


def _stack(tracks, dim: int = 0):
    """List of track records (or tables) → one table with a new axis at
    ``dim``: the slot axis, or a channel or frame axis."""
    first = tracks[0]
    return {k: _stack([t[k] for t in tracks], dim)
            if isinstance(first[k], dict)
            else torch.stack([t[k] for t in tracks], dim) for k in first}


def _map(fn, table):
    """fn applied to every leaf of a (nested) dict of tensors."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in table.items()}


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


def to_host(table) -> dict:
    """A (nested) dict of tensors, such as a track table or a tracker's
    history, as host numpy arrays."""
    return {k: to_host(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in table.items()}


def init_tracks(n_tracks: int, device=None, channels: int | None = None):
    """A table of ``n_tracks`` free tracks on ``device``; with ``channels``
    one such table a channel, leaves (channels, n_tracks, …)."""
    table = _stack([make_track(None, device) for _ in range(n_tracks)])
    if channels is None:
        return table
    return _stack([table] * channels)


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

def _slot_loop(tracks, cand: torch.Tensor, valid: torch.Tensor,
               n_tracks: int):
    """One frame of one channel's (n_tracks, …) table: the slots in
    priority order, each associated from the shared pool and advanced.
    Returns a new table."""
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


def multitarget_step_plain(table, cand: torch.Tensor, valid: torch.Tensor,
                           n_tracks: int):
    """The plain version of the tracker kernel (``tracker_kernel``'s
    contract): a (C, n_tracks, …) table, (C, T, 3, K) candidates and (C, T,
    K) masks → the (T, C, n_tracks, …) tables after each frame, a channel
    at a time, a frame at a time, each frame a loop over the slots."""
    channels = []
    for c in range(cand.shape[0]):
        tracks = _slot(table, c)
        frames = []
        for t in range(cand.shape[1]):
            tracks = _slot_loop(tracks, cand[c, t], valid[c, t], n_tracks)
            frames.append(tracks)
        channels.append(_stack(frames))
    return _stack(channels, dim=1)


def multitarget_step(tracks, frame, frame_extent, n_tracks: int, k_max: int):
    """One tracker update from one CFAR frame (the streaming entry point).

    frame (nf, nr) with a table of (n_tracks, …) leaves, or (C, nf, nr)
    with one of (C, n_tracks, …) leaves: each channel's table advanced by
    its own frame. On the card one batched get_measurements and one kernel
    launch for every channel, with no host read; on the CPU the plain
    version. Returns a new table; ``tracks`` is left as it was."""
    cand, valid = get_measurements(frame, frame_extent, k_max)
    single = cand.dim() == 2
    if single:
        cand, valid = cand[None], valid[None]
        tracks = _map(lambda a: a[None], tracks)
    hist = multitarget_step_kernel(tracks, cand[:, None], valid[:, None],
                                   n_tracks)
    return _map(lambda a: a[0, 0] if single else a[0], hist)


# --------------------------------------------------------------------------
# batch trackers over a frame stack
# --------------------------------------------------------------------------

def _orient_stack(data, frames_last, device=None) -> torch.Tensor:
    """Normalise a frame stack to a frames-first float32 tensor on
    ``device`` (default: the CUDA card).

    frames_last=None guesses ONLY when unambiguous: the candidate frame
    axis (first or last) must be at most half of both map dimensions of its
    interpretation, and only one interpretation may qualify. Anything else
    raises — a silently wrong orientation produces garbage tracks, so an
    ambiguous stack (frame count rivaling a map dimension, e.g. the
    reference FM geometry's (1024, 176, 1200)) requires an explicit
    frames_last from the caller. The CLI surfaces always pass it.
    """
    if not torch.is_tensor(data):
        data = np.asarray(data, np.float32)
    data = on_device(data, resolve_device(device)).float()
    if data.dim() != 3:
        raise ValueError("expected a 3-D frame stack")
    if frames_last is None:
        last_ok = data.shape[2] * 2 <= min(data.shape[0], data.shape[1])
        first_ok = data.shape[0] * 2 <= min(data.shape[1], data.shape[2])
        if last_ok == first_ok:
            raise ValueError(
                f"cannot infer frame-stack orientation for shape "
                f"{tuple(data.shape)} — the frame count rivals the map "
                "dimensions; pass frames_last explicitly (True for the "
                "reference (doppler, range, frames) file layout)")
        frames_last = last_ok
    if frames_last:
        data = data.movedim(2, 0)
    return data


def multitarget_tracker(data, frame_extent, n_tracks: int = 10,
                        k_max: int = 384, frames_last: bool | None = None,
                        device=None):
    """Track up to ``n_tracks`` targets through a stack of range-Doppler maps.

    data: (num_doppler, num_range, num_frames), the reference's file layout
    (target_detection.py:455-526, pass frames_last=True), or
    (num_frames, num_doppler, num_range) (frames_last=False); the default
    guesses from the shapes (see _orient_stack). frame_extent:
    (max_doppler_hz, max_range_km). Runs on ``device`` (default: the CUDA
    card): every frame's candidates in one batched call, then the whole
    stack in one tracker-kernel launch (the plain version on the CPU).

    Returns a dict of tensors with leading axes (num_frames, n_tracks):
    status, lifetime, measurement, estimate, history, kalman.*.
    """
    frames = _orient_stack(data, frames_last, device)
    extent = torch.as_tensor(frame_extent, dtype=torch.float32,
                             device=frames.device)
    n_tracks = int(n_tracks)
    cand, valid = get_measurements(frames, extent, int(k_max))
    hist = multitarget_step_kernel(
        init_tracks(n_tracks, frames.device, channels=1), cand[None],
        valid[None], n_tracks)
    return _map(lambda a: a[:, 0], hist)


# --------------------------------------------------------------------------
# single-target tracker (reference target_detection.py:530-681)
# --------------------------------------------------------------------------

_LOCK_FOUND = np.array([[0, 1, 0, 0], [0, 0, 1, 0],
                        [0, 0, 1, 0], [0, 0, 1, 0]], np.float32).T
_LOCK_LOST = np.array([[1, 0, 0, 0], [1, 0, 0, 0],
                       [0, 0, 0, 1], [1, 0, 0, 0]], np.float32).T


def _simple_kalman_init(device):
    st = default_kalman_state(30.0, -20.0, device=device)
    # the simple tracker's own filter constants (reference
    # target_detection.py:634-641, after Howland et al.)
    consts = dict(
        x=np.array([30, 2, -20, -1], np.float32),
        F1=np.array([[1, 0, -0.003, 0], [0, 0, -0.003, -0.03],
                     [0, 0, 1, 1], [0, 0, 0, 1]], np.float32),
        Q=np.diag([2.0, 0.02, 0.2, 0.05]).astype(np.float32),
        R=np.diag([5.0, 5.0]).astype(np.float32))
    st.update({k: torch.from_numpy(v).to(device) for k, v in consts.items()})
    return st


def _py_slice_mask(coords: torch.Tensor, idx: torch.Tensor, half, n: int):
    """Boolean mask of ``coords`` selected by the Python slice
    ``a[idx-half : idx+half]`` on a length-n axis — including the
    negative-start wraparound quirk: for idx < half the start index
    becomes n+idx-half, which usually EXCEEDS the stop and yields an
    empty selection (the reference's literal gate behavior,
    target_detection.py:570-588)."""
    start = torch.where(idx >= half, idx - half,
                        torch.clamp(n + idx - half, min=0))
    stop = torch.clamp(idx + half, max=n)
    return (coords >= start) & (coords < stop)


def _simple_scan(frames: torch.Tensor, range_extent: float,
                 doppler_extent: float, strict: bool = False):
    """The lock-state frame loop over (F, nr, nf) prepared frames, on their
    device. Returns the per-frame states stacked: lock_mode, measurement,
    meas_idx, estimate, kalman.*."""
    dev = frames.device
    nr, nf = frames.shape[1], frames.shape[2]
    rows = torch.arange(nr, device=dev)[:, None]
    cols = torch.arange(nf, device=dev)[None, :]
    r_ext = torch.tensor(range_extent, dtype=torch.float32, device=dev)
    d_ext = torch.tensor(doppler_extent, dtype=torch.float32, device=dev)
    t_found = torch.from_numpy(_LOCK_FOUND).to(dev)
    t_lost = torch.from_numpy(_LOCK_LOST).to(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def const(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    st = dict(
        lock_mode=const([1, 0, 0, 0], torch.float32),
        measurement=const([35.0, -30.0], torch.float32),
        meas_idx=const([50, 50], torch.int32),
        estimate=const([30.0, -20.0], torch.float32),
        kalman=_simple_kalman_init(dev),
    )
    history = []
    for frame in frames:
        ly, lx = st["meas_idx"][0], st["meas_idx"][1]
        lock = st["lock_mode"]
        locked = lock[2] == 1
        half_r = torch.where(locked, 16, 24)
        half_d = torch.where(locked, 32, 48)
        if strict:
            # literal reference gate: Python-slice semantics incl. the
            # negative-start empty-gate quirk
            gate = (_py_slice_mask(rows, ly, half_r, nr)
                    & _py_slice_mask(cols, lx, half_d, nf))
        else:
            # generalised: centred rectangle clamped at the frame edges
            gate = ((rows - ly).abs() < half_r) & ((cols - lx).abs() < half_d)
        use_gate = lock[0] != 1
        gated = torch.where(use_gate & ~gate, zero, frame)

        flat = torch.argmax(gated.reshape(-1))
        iy, ix = flat // nf, flat % nf
        range_meas = r_ext * (1.0 - iy / nr)
        doppler_meas = d_ext * (2.0 * ix / nf - 1.0)
        meas = torch.stack([range_meas, doppler_meas]).to(torch.float32)

        surprise = meas - st["estimate"]
        badness = torch.sqrt(surprise[0] ** 2 + (0.5 * surprise[1]) ** 2)
        found = badness < 12
        new_lock = torch.where(found, t_found @ lock, t_lost @ lock)

        est, kal = adaptive_kalman_update(meas, st["measurement"],
                                          st["kalman"])
        st = dict(lock_mode=new_lock, measurement=meas,
                  meas_idx=torch.stack([iy, ix]).to(torch.int32),
                  estimate=est, kalman=kal)
        history.append(st)
    return _stack(history)


def simple_target_tracker(data, range_extent: float, doppler_extent: float,
                          frames_last: bool | None = None,
                          strict: bool = False, device=None):
    """Single-target lock-state tracker (reference
    target_detection.py:626-681), on ``device`` (default: the CUDA card).

    data: (num_doppler, num_range, num_frames) (frames_last=True) or
    frames-first (frames_last=False); the default guesses from the shapes.
    Each frame is normalised, reoriented and clutter-zeroed, then the gated
    argmax becomes the measurement for an adaptive Kalman update; a 4-state
    lock-mode one-hot is advanced through the found/lost transition
    matrices.

    ``strict=True`` replicates the reference's literal per-frame behaviours
    (the tracker analog of cfg.strict_frame_parity): the hard-coded Doppler
    cols-250:260 clutter zeroing (a no-op when nf <= 250, exactly as in
    numpy) instead of the centre-relative ±5 zeroing, and Python-slice
    measurement gates including the negative-start empty-gate quirk
    (target_detection.py:570-588) instead of edge-clamped rectangles.

    Returns a dict of tensors with a leading frame axis: lock_mode (F, 4),
    measurement (F, 2), meas_idx (F, 2) int32, estimate (F, 2), kalman.*.
    """
    data = _orient_stack(data, frames_last, device)
    nf = data.shape[1]

    # per-frame normalise / orient / zero (reference
    # target_detection.py:663-673)
    frames = data / data.abs().mean(dim=(1, 2), keepdim=True)
    frames = torch.flip(frames.transpose(1, 2), dims=(2,))  # (F, nr, nf)
    frames[:, :8, :] = 0.0
    frames[:, -8:, :] = 0.0
    if strict:
        frames[:, :, 250:260] = 0.0
    else:
        dc = nf // 2
        frames[:, :, dc - 5:dc + 5] = 0.0
    return _simple_scan(frames, float(range_extent), float(doppler_extent),
                        strict=strict)
