"""b2_roofline.capture: B2's (``csrc/nlms.cu``, the NLMS canceller) share
of its roofline, in %, at the batch's shape: one launch a batch over its
frame_batch + 2 frames of out_len samples, num_range_cells + 10 taps
(``core/work_nlms.py``; moves frames_per_s)."""

from benchmark.core import roofline, work_nlms


def read(ctx):
    g = ctx.geometry
    flops, nbytes = work_nlms.b2_nlms(int(ctx.cell.config["frame_batch"]) + 2,
                                      g["out_len"], g["num_range_cells"] + 10)
    return roofline.share(ctx, "b2_roofline.capture", "nlms_kernel", flops,
                          nbytes)
