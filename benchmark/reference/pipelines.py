"""The reference chain assembled as the two configurations run it.

``fm_clean`` and ``fm_maps``: the FM path (mix, resample, LS canceller,
halo, windowed CAF) for frames given by their raw IQ and global index;
``wideband_maps``: the wideband path (channelizer, per-channel LS
canceller, windowed CAF, no overlap). ``g`` is ``geometry.derive`` of the
configuration file.
"""

from __future__ import annotations

import torch

from benchmark.reference import chain
from benchmark.reference.precision import FP64, Precision


def fm_clean(raw_ref: torch.Tensor, raw_srv: torch.Tensor, frame_index,
             g: dict, prec: Precision = FP64) -> tuple:
    """(F, frame_len) complex raw frames at global indices ``frame_index``
    → (ref, srv_clean), each (F, out_len) at the IF rate."""
    ph = chain.block_phases(frame_index, g["frame_len"], g["offset_freq"],
                            g["fs"])

    def pre(x):
        y = chain.resample(chain.mix(x, g["offset_freq"], g["fs"], ph, prec),
                           g["up"], g["down"], prec)
        return chain.fit_length(y, g["out_len"])

    ref = pre(raw_ref)
    srv = pre(raw_srv)
    return ref, chain.ls_multiple(ref, srv, g["num_range_cells"],
                                  g["if_rate"], g["bins"], prec)


def fm_maps(ref: torch.Tensor, srv: torch.Tensor, g: dict, left=None,
            right=None, prec: Precision = FP64) -> torch.Tensor:
    """Cleaned (F, out_len) frames → (F, nf, R + 1) maps; ``left`` and
    ``right`` are the (ref, srv) cleaned neighbours of the first and last
    frame, None at a capture's edge."""
    h = g["halo"]
    n = g["out_len"] + 2 * h
    win = chain.kaiser_periodic(n, float(g["window"][1]))
    ref_ov = chain.halo(ref, h, None if left is None else left[0],
                        None if right is None else right[0])
    srv_ov = chain.halo(srv, h, None if left is None else left[1],
                        None if right is None else right[1])
    return torch.stack([chain.caf(ref_ov[i:i + 1], srv_ov[i:i + 1],
                                  g["num_range_cells"],
                                  g["num_doppler_cells"], win, prec)[0]
                        for i in range(ref.shape[0])])


def wideband_maps(raw_ref: torch.Tensor, raw_srv: torch.Tensor, g: dict,
                  prec: Precision = FP64) -> torch.Tensor:
    """(F, K·cpi) complex wideband CPIs → (F, S, nf, R + 1) maps of the
    selected channels."""
    sel = list(g["select"])
    cpi = g["cpi_samples"]
    win = chain.kaiser_periodic(cpi, float(g["window"][1]))
    out = []
    for i in range(raw_ref.shape[0]):
        rc = chain.channelize(raw_ref[i:i + 1], g["channels"],
                              g["taps_per_branch"], prec)[0]
        sc = chain.channelize(raw_srv[i:i + 1], g["channels"],
                              g["taps_per_branch"], prec)[0]
        rc = rc.T[sel, :cpi]
        sc = sc.T[sel, :cpi]
        clean = chain.ls_multiple(rc, sc, g["num_range_cells"], g["if_rate"],
                                  g["bins"], prec)
        out.append(chain.caf(rc, clean, g["num_range_cells"],
                             g["num_doppler_cells"], win, prec))
    return torch.stack(out)
