"""l1_roofline.capture: L1's (``csrc/levinson.cu``, the LS canceller's
Levinson recursion) share of its roofline, in %, at the batch's shape: one
launch for every frame and Doppler bin of a batch (FM: frame_batch + 2
frames; wideband: frame_batch CPIs times the selected channels), systems
of order num_range_cells + 10 (moves frames_per_s)."""

from benchmark.core import roofline


def read(ctx):
    g = ctx.geometry
    bf = int(ctx.cell.config["frame_batch"])
    rows = bf * len(g["select"]) if g["channels"] else bf + 2
    flops, nbytes = ctx.work.l1_levinson(rows * len(g["bins"]),
                                         g["num_range_cells"] + 10)
    return roofline.share(ctx, "l1_roofline.capture", "levinson_kernel",
                          flops, nbytes)
