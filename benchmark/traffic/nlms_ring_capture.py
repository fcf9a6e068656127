"""Traffic kind ``nlms_ring_capture``: ``ring_capture``'s back-to-back
captures through ``pipeline.run_capture``, for an FM configuration whose
canceller is NLMS (``clutter_method`` ``nlms_pallas``).

The mix's parameters, the ring, its reader and sink, the inputs, the
set-up, the window and ``frames_per_s`` are ``ring_capture``'s, by import.
What differs is the reference: the FM clean stage with the NLMS canceller
(reference/nlms.py), at the configuration's ``nlms_mu``. The NLMS loop is
serial in the samples, so the check cleans every frame that its sample
needs (each kept frame and its two neighbours, once each, by ring slot and
frame index) as one batch in one float64 loop, then takes each map.

The window notes the NLMS frames filtered over the frames written
(``nlms_filter_batch.frames``, where the port counts them): each batch
filters its two halo frames again.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry, nlms, pipelines
from benchmark.reference.precision import FP64, Precision
from benchmark.traffic import ring_capture as ring

State = ring.State
make_inputs, setup, release = ring.make_inputs, ring.setup, ring.release
sample, peak_error = ring.sample, ring.peak_error


def _filtered():
    """The port's count of frames that the NLMS kernel filtered, or None
    where it keeps no such count."""
    from passiveradar_torch.ops import nlms_kernel
    return getattr(nlms_kernel.nlms_filter_batch, "frames", None)


def window(state: State, seconds: float) -> dict:
    before = _filtered()
    out = ring.window(state, seconds)
    after = _filtered()
    written = out["attempted"] - out["failed"]
    if before is None or after is None:
        out["notes"].append("NLMS frames filtered: the port keeps no "
                            "nlms_filter_batch.frames")
    else:
        out["notes"].append(
            f"NLMS frames filtered {after - before} over frames written "
            f"{written}: {(after - before) / max(written, 1):.4f}")
    return out


def _raw(state: State, ring_arr, slots, prec: Precision) -> torch.Tensor:
    """Ring slots ``slots`` of int16 IQ pairs as complex frames."""
    x = torch.from_numpy(np.ascontiguousarray(ring_arr[slots])).to(
        state.device).to(prec.real) * state.g["int16_scale"]
    return torch.complex(x[..., 0], x[..., 1])


def reference_frames(state: State, pairs, prec: Precision = FP64) -> dict:
    """The reference's maps, (nf, R + 1) each, at every (capture, position)
    of ``pairs``: the frames they need, cleaned as one batch."""
    n = state.cell.mix["call_frames"]
    r = state.cell.mix["ring_frames"]
    rows: dict = {}                        # (ring slot, frame index) → row
    plan = []
    for c, p in pairs:
        lo, hi = max(0, p - 1), min(n, p + 2)
        plan.append((c, p, lo, hi, [rows.setdefault(((c + i) % r, i),
                                                    len(rows))
                                    for i in range(lo, hi)]))
    slots = [s for s, _ in rows]
    ref, srv = nlms.fm_clean(_raw(state, state.ring_ref, slots, prec),
                             _raw(state, state.ring_srv, slots, prec),
                             [i for _, i in rows], state.g,
                             float(state.cell.config["nlms_mu"]), prec)
    out = {}
    for c, p, lo, hi, idx in plan:
        i, row = p - lo, idx[p - lo]
        left = (ref[idx[i - 1]], srv[idx[i - 1]]) if i > 0 else None
        right = (ref[idx[i + 1]], srv[idx[i + 1]]) if p + 1 < hi else None
        out[c, p] = pipelines.fm_maps(ref[row:row + 1], srv[row:row + 1],
                                      state.g, left, right, prec)[0]
    return out


def reference_frame(state: State, capture: int, pos: int,
                    prec: Precision = FP64) -> torch.Tensor:
    """The reference's maps of frame ``pos`` of capture ``capture``."""
    return reference_frames(state, [(capture, pos)], prec)[capture, pos]


def control(cell, seed: int, device, prec: Precision) -> State:
    """The state a run of ``control_captures`` captures would hold, with
    the reference in precision ``prec`` in the program's place at every
    (capture, position) the check samples."""
    state = State(cell, None, geometry.derive(cell.config),
                  *make_inputs(cell, seed, device),
                  keep=ring._keep(cell, seed), seed=seed, device=device)
    state.captures = [{} for _ in range(cell.check["control_captures"])]
    for (c, p), got in reference_frames(state, sample(state, seed),
                                        prec).items():
        state.captures[c][p] = got.cpu().numpy()
    return state


def check(state: State) -> list:
    want = reference_frames(state, sample(state, state.seed))
    worst = max(peak_error(state.captures[c][p], w)
                for (c, p), w in want.items())
    return [("map_err", worst, state.cell.check["limits"]["map_err"])]
