"""CFAR and the multitarget tracker step, in plain NumPy (float64).

From the upstream processor's target_detection.py: ``cfar`` is CFAR_2D
(:683-703) with the stream's normalisation (the frame over its mean |x|,
over the wrap-padded background); ``measurements`` is get_measurements
(:164-229: the frame reoriented as fliplr(frame.T), the edge range rows
and the zero-Doppler columns zeroed, the 99.8th percentile as threshold,
the candidates strongest first, at most ``k_max``); ``step`` is one frame
of multitarget_tracker (:455-526): the slots in priority order (confirmed,
preliminary, free; by index within each), each gated and associated from
the shared candidate pool (associate_measurements, :231-348), then
initialised, updated or extrapolated (initialize_track :350-396,
update_track :398-453, the Kalman updates :19-148).

A track table is a dict of arrays with a leading slot axis: status,
lifetime, measurement (2), estimate (2), history (N), and kalman: x (4),
P, F1, F2, Q (4×4), H (2×4), R, S (2×2), the layout the port's tables are
read back to the host in.
"""

from __future__ import annotations

import numpy as np


def exact(x):
    return np.asarray(x, np.float64)


def tf32(x):
    """``x`` in float32 with each value rounded to TF32's 10-bit mantissa:
    the tracker of the correctness control."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def fp32(x):
    return np.asarray(x, np.float32)


ROUNDING = dict(fp64=exact, fp32=fp32, tf32=tf32)

F1 = np.array([[1, 0, -0.003, 0], [0, 0, -0.003, -0.003],
               [0, 0, 1, 1], [0, 0, 0, 1]], np.float64)
F2 = np.array([[1, 1, 0, 0], [0, 1, 0, 0],
               [0, 0, 1, 1], [0, 0, 0, 1]], np.float64)
H = np.array([[1, 0, 0, 0], [0, 0, 1, 0]], np.float64)
P0 = np.diag([5.0, 0.0225, 0.04, 0.1])
Q = np.diag([4.0, 0.03, 0.2, 0.08])
R = np.diag([5.0, 2.0])


def cfar_kernel(fw: int, gw: int) -> np.ndarray:
    t = np.ones((fw, fw)) / (fw ** 2 - gw ** 2)
    e1 = (fw - gw) // 2
    e2 = fw - e1 + 1
    t[e1:e2, e1:e2] = 0
    return t


def cfar(x: np.ndarray, fw: int, gw: int) -> np.ndarray:
    """x (…, H, W) magnitudes → the CFAR ratio (x / mean |x|) / (background
    + 1e-10), the background x's 'same' 2-D convolution with the kernel,
    wrapping at the edges (scipy.signal.convolve2d(boundary='wrap'))."""
    x = np.asarray(x, np.float64)
    h, w = x.shape[-2:]
    c = (fw - 1) // 2
    t = np.zeros((h, w))
    t[:fw, :fw] = cfar_kernel(fw, gw)
    full = np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(t)).real
    background = np.roll(full, (-c, -c), axis=(-2, -1))
    norm = x / np.abs(x).mean(axis=(-2, -1), keepdims=True)
    return norm / (background + 1e-10)


def measurements(frame: np.ndarray, extent, k_max: int,
                 percentile: float = 99.8) -> tuple:
    """(cand (3, k_max) [range, doppler, strength], valid (k_max,))."""
    frame = np.asarray(frame, np.float64)
    nf, nr = frame.shape
    x = np.fliplr(frame.T) / np.abs(frame).mean()
    x = x.copy()
    x[:8, :] = 0
    x[-8:, :] = 0
    dc = nf // 2
    x[:, dc - 4:dc + 4] = 0
    flat = x.reshape(-1)
    threshold = np.percentile(flat, percentile)
    order = _strongest(flat, k_max)
    strength = flat[order]
    rpts = np.linspace(extent[1], 0.0, nr)
    dpts = np.linspace(-extent[0], extent[0], nf)
    cand = np.stack([rpts[order // nf], dpts[order % nf], strength])
    return cand, strength >= threshold


def _strongest(flat: np.ndarray, k: int) -> np.ndarray:
    """The indices of the ``k`` largest values, largest first, ties by
    index: ``np.argsort(-flat, kind="stable")[:k]``, sorting only the
    values at or above the k-th largest."""
    k = min(k, flat.size)
    kth = np.partition(flat, flat.size - k)[flat.size - k] if k else 0.0
    if not np.isfinite(kth):
        return np.argsort(-flat, kind="stable")[:k]
    sel = np.flatnonzero(flat >= kth)
    return sel[np.argsort(-flat[sel], kind="stable")][:k]


def _fresh(meas=None) -> dict:
    m = np.zeros(2) if meas is None else np.asarray(meas, np.float64)
    hist = np.zeros(20)
    hist[0] = 1
    hist[5:10] = 1
    return dict(status=0 if meas is None else 1, lifetime=1,
                measurement=m.copy(), estimate=m.copy(), history=hist,
                kalman=dict(x=np.array([m[0], 0.0, m[1], -1.0]),
                            P=P0.copy(), F1=F1.copy(), F2=F2.copy(),
                            Q=Q.copy(), H=H.copy(), R=R.copy(),
                            S=np.eye(2)))


def _advance(k: dict, r_scale: float, q) -> tuple:
    x = q(k["F1"] @ k["x"])
    p = q(k["F2"] @ q(k["P"] @ k["F2"].T) + k["Q"])
    s = q(k["H"] @ q(p @ k["H"].T) + k["R"] * r_scale)
    return x, p, s


def _update(track: dict, meas, found: bool, q) -> dict:
    k = track["kalman"]
    if found:
        d = meas - track["measurement"]
        x, p, s = _advance(k, q(d[0] ** 2 + d[1] ** 2), q)
        gain = q(q(p @ k["H"].T) @ q(np.linalg.inv(s)))
        x = q(x + gain @ q(meas - k["H"] @ x))
        p = q(q(np.eye(4) - gain @ k["H"]) @ p)
    else:
        x, p, s = _advance(k, 1.0, q)
    hist = track["history"]
    old = track["lifetime"] > 4
    s10, s20 = hist[:10].sum(), hist.sum()
    status = track["status"]
    if status == 1:
        status = 0 if old and s10 < 6 else (2 if old and s10 > 8 else 1)
    elif status == 2:
        status = 0 if old and s20 < 4 else 2
    return dict(status=status, lifetime=track["lifetime"] + 1,
                measurement=np.array(meas) if found
                else track["measurement"].copy(),
                estimate=q(k["H"] @ x),
                history=np.concatenate([[float(found)], hist[:-1]]),
                kalman=dict(k, x=x, P=p, S=s))


def _associate(track: dict, cand: np.ndarray, avail: np.ndarray) -> tuple:
    r, d = cand[0], cand[1]
    status = track["status"]
    lm, le = track["measurement"], track["estimate"]
    if status == 0:
        early = np.ones_like(avail)
    elif status == 1:
        early = (np.abs(r - lm[0]) < 5) & (np.abs(d - lm[1]) < 24)
    else:
        early = (np.abs(r - le[0]) < 4) & (np.abs(d - le[1]) < 20)
    gated = early & avail
    if status == 2:
        si = np.linalg.inv(track["kalman"]["S"])
        zr, zd = lm[0] - r, lm[1] - d
        m2 = zr * (si[0, 0] * zr + si[0, 1] * zd) \
            + zd * (si[1, 0] * zr + si[1, 1] * zd)
        gated = gated & (m2 < 6)
    count = int(gated.sum())
    if count == 0:
        return None, avail
    if status == 1:      # the candidate nearest the origin (kept quirk)
        choice = int(np.argmin(np.where(gated, np.hypot(r, d), np.inf)))
    else:                # the strongest
        choice = int(np.argmax(gated))
    meas = np.array([r[choice], d[choice]])
    if status == 0:
        removal = ((np.abs(r - meas[0]) < 10) & (np.abs(d - meas[1]) < 12)) \
            if count > 1 else np.ones_like(avail)
    else:
        removal = early
    return meas, avail & ~removal


def slot(table: dict, i: int) -> dict:
    return {k: slot(v, i) if isinstance(v, dict) else v[i]
            for k, v in table.items()}


def stack(tracks: list) -> dict:
    first = tracks[0]
    return {k: stack([t[k] for t in tracks]) if isinstance(first[k], dict)
            else np.stack([np.asarray(t[k]) for t in tracks])
            for k in first}


def init_table(n_tracks: int) -> dict:
    return stack([_fresh() for _ in range(n_tracks)])


def step(table: dict, frame: np.ndarray, extent, k_max: int,
         q=exact) -> dict:
    """One tracker frame on a CFAR frame (num_doppler, num_range): the new
    table. ``q`` rounds every float the step makes (``tf32`` for the
    control)."""
    cand, valid = measurements(frame, extent, k_max)
    cand = q(cand)
    n = len(table["status"])
    tracks = [slot(table, i) for i in range(n)]
    prio = {2: 0, 1: 1, 0: 2}
    order = sorted(range(n), key=lambda i: (prio[int(tracks[i]["status"])],
                                            i))
    avail = valid.copy()
    for i in order:
        tr = dict(tracks[i], status=int(tracks[i]["status"]),
                  lifetime=int(tracks[i]["lifetime"]))
        meas, avail = _associate(tr, cand, avail)
        if tr["status"] == 0:
            tracks[i] = _fresh(meas) if meas is not None else tr
        else:
            tracks[i] = _update(tr, meas, meas is not None, q)
    return stack(tracks)


DISCRETE = ("status", "lifetime", "history")


def compare(got: dict, want: dict) -> tuple:
    """(mismatches, float error) of a track table against the reference's:
    the count of slots whose status, lifetime or history differ, and the
    worst leaf's max |got − want| over max(|want|, 1) among the free-float
    leaves (measurement, estimate, Kalman x, P, S) of the slots that
    agree."""
    same = np.ones(len(want["status"]), bool)
    for k in DISCRETE:
        a = np.asarray(got[k]).reshape(len(same), -1)
        b = np.asarray(want[k]).reshape(len(same), -1)
        same &= np.all(a == b, axis=1)
    err = 0.0
    leaves = [(got[k], want[k]) for k in ("measurement", "estimate")] + \
        [(got["kalman"][k], want["kalman"][k]) for k in ("x", "P", "S")]
    for a, b in leaves:
        a = np.asarray(a, np.float64)[same]
        b = np.asarray(b, np.float64)[same]
        if b.size:
            err = max(err, float(np.max(np.abs(a - b))
                                 / max(np.max(np.abs(b)), 1.0)))
    return int((~same).sum()), err
