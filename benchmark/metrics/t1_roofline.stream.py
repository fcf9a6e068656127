"""t1_roofline.stream: T1's (``csrc/tracker.cu``, the multitarget tracker
step) share of its roofline, in %, at the push's shape: one launch for
every tracked channel (1 at FM, the selected channels wideband), the mix's
n_tracks slots, the candidate budget max(max_measurements, ⌊0.003 · cells⌋)
(moves push_ms_p50)."""

from benchmark.core import roofline


def read(ctx):
    g = ctx.geometry
    channels = len(g["select"]) if g["channels"] else 1
    cells = g["num_doppler_cells"] * (g["num_range_cells"] + 1)
    k = max(int(ctx.cell.config["max_measurements"]), int(0.003 * cells))
    flops, nbytes = ctx.work.t1_tracker(channels, ctx.cell.mix["n_tracks"],
                                        k)
    return roofline.share(ctx, "t1_roofline.stream", "tracker_kernel",
                          flops, nbytes)
