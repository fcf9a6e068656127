"""b1_roofline.capture: B1's (``csrc/mix_regroup.cu``, the fused mixer and
polyphase resampler) share of its roofline, in %, at the batch's shape:
one launch a channel over the batch's frame_batch + 2 frames (moves
frames_per_s)."""

from benchmark.core import roofline


def read(ctx):
    g = ctx.geometry
    frames = int(ctx.cell.config["frame_batch"]) + 2
    flops, nbytes = ctx.work.b1_resampler(frames, g["frame_len"], g["up"],
                                          g["down"])
    return roofline.share(ctx, "b1_roofline.capture", "mix_regroup_kernel",
                          flops, nbytes)
