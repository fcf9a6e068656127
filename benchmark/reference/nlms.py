"""The adaptive NLMS canceller and the FM clean stage that runs it, in plain
PyTorch.

``nlms`` follows ``NLMS_filter`` (Max-Manning/passiveRadar
clutter_removal.py:189-249): for each sample the tap input vector from the
reference, the error of the surveillance sample against the filter's
output, and the normalised update w ← w + μ·u·e*/(uᴴu) (:211-215), one
sample after another over the CPI (:234-244). Rows are frames, each with
its own filter; the loop over samples is shared by all rows.

Departures from upstream, each the convention of the pipeline it is held
against:

* m = filter_len + peek taps, and at step k the window u = ref[k+1 :
  k+1+m] in natural order with the taps kept in that order (upstream
  flips the window and the taps: the same products, the same sums);
* the error of step k is written at filter_len + k, for the n − m steps,
  and the output is zero elsewhere;
* the division by uᴴu is guarded as max(uᴴu, 1e-30), so an all-zero
  window (a zero frame at a capture's edge) leaves the taps as they are
  where the plain division gives NaN; uᴴu is summed in float64 over each
  window (as a difference of running sums);
* the taps start at zero in every frame (no ``initialTaps``, no warm
  start from the previous frame);
* every row is filtered at once, in float64 (``prec`` FP64).

``prec`` is ``precision.FP64`` (the reference) or ``precision.TF32`` (the
control): then the inputs are rounded to TF32, and at every step the
operands of the dot product wᴴu (the window, the taps) and the error, as a
TF32 dot product would take and give them; the taps themselves are kept
in complex64.

``fm_clean`` is ``pipelines.fm_clean`` with this canceller in place of
``ls_multiple``: the mix and the resampler of ``chain``, by import.
"""

from __future__ import annotations

import torch

from benchmark.reference import chain
from benchmark.reference.precision import FP64, Precision

PEEK = 10           # LS_Filter_Toeplitz's peek, the pipeline's for NLMS too
GUARD = 1e-30       # the floor of uᴴu
CHUNK = 4           # frames resampled at a time: its FFT is 2^25 points


def nlms(ref: torch.Tensor, srv: torch.Tensor, filter_len: int, mu: float,
         prec: Precision = FP64, peek: int = PEEK) -> torch.Tensor:
    """NLMS_filter on (F, n) rows, each with zero initial taps → (F, n)
    cleaned surveillance rows (see the module docstring)."""
    ref, srv = prec.q(ref), prec.q(srv)
    f, n = ref.shape
    m = filter_len + peek
    steps = n - m
    if filter_len < 1 or peek < 0 or steps < 1:
        raise ValueError(f"need filter_len >= 1, peek >= 0 and n > "
                         f"filter_len + peek, got {filter_len}, {peek}, {n}")
    rounded = prec.name == "tf32"
    # uᴴu of window k = ref[k+1 : k+1+m], from float64 running sums
    power = ref.real.double() ** 2 + ref.imag.double() ** 2
    run = torch.nn.functional.pad(torch.cumsum(power, dim=-1), (1, 0))
    uu = run[:, 1 + m:1 + m + steps] - run[:, 1:1 + steps]
    scale = prec.q((mu / uu.clamp_min(GUARD)).to(prec.real))
    windows = ref[:, 1:].unfold(-1, m, 1)                   # (F, steps, m)
    d = srv[:, filter_len:filter_len + steps]
    w = torch.zeros((f, m), dtype=prec.complex, device=ref.device)
    out = torch.zeros((f, n), dtype=prec.complex, device=ref.device)
    err = out[:, filter_len:filter_len + steps]
    for k in range(steps):
        u = windows[:, k]
        e = d[:, k] - torch.linalg.vecdot(prec.q(w) if rounded else w, u)
        if rounded:
            e = prec.q(e)
        err[:, k] = e
        w.addcmul_(u, (e.conj() * scale[:, k]).unsqueeze(-1))
    return out


def fm_clean(raw_ref: torch.Tensor, raw_srv: torch.Tensor, frame_index,
             g: dict, mu: float, prec: Precision = FP64) -> tuple:
    """(F, frame_len) complex raw frames at global indices ``frame_index``
    → (ref, srv_clean), each (F, out_len) at the IF rate: both channels
    mixed and resampled ``CHUNK`` frames at a time, then every frame
    through ``nlms`` at once with filter_len = num_range_cells."""
    index = list(frame_index)
    ph = chain.block_phases(index, g["frame_len"], g["offset_freq"], g["fs"])

    def pre(x):
        return torch.cat([chain.fit_length(chain.resample(chain.mix(
            x[i:i + CHUNK], g["offset_freq"], g["fs"], ph[i:i + CHUNK], prec),
            g["up"], g["down"], prec), g["out_len"])
            for i in range(0, x.shape[0], CHUNK)])

    ref = pre(raw_ref)
    return ref, nlms(ref, pre(raw_srv), g["num_range_cells"], mu, prec)
