"""Multi-target Kalman tracker CLI (reference multitarget_kalman_tracker.py).

    python -m passiveradar_torch.cli.track_multi --config cfg.yaml \
        [--mode plot|video|frames] [--input STACK] [--device cpu]

Port of the JAX package's cli/track_multi.py: the map stack is loaded,
CFAR-normalised and tracked on the device (``track``), then plotted to
./MULTITARGET_PLOT.png or rendered with the confirmed tracks' trails.
"""

from __future__ import annotations

import numpy as np

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, \
    fail_on_missing_capture, load, parser
from passiveradar_torch.cli.plot import add_input, cfar_stack
from passiveradar_torch.detect.trackers import multitarget_tracker, to_host
from passiveradar_torch.io.writers import load_maps
from passiveradar_torch.viz.render import render_video

N_TRACKS = 10  # reference multitarget_kalman_tracker.py:60
TRAIL = 20     # fading-trail length in the video overlay


def track(cfg, path: str | None = None, device=None):
    """load_maps → cfar_stack → multitarget_tracker on ``device`` (default:
    the CUDA card). Returns the CFAR stack (doppler, range, frames) and the
    tracker's history as host arrays with leading axes (frames, N_TRACKS)."""
    dev = resolve_device(device)
    cf = cfar_stack(load_maps(cfg, path=path), device=dev)
    hist = multitarget_tracker(
        cf, (cfg.max_doppler_actual, cfg.max_range_actual), N_TRACKS,
        k_max=cfg.candidate_budget, frames_last=True, device=dev)
    return cf, to_host(hist)


@fail_on_missing_capture
def main(argv=None):
    """Returns the tracker's history (host arrays)."""
    p = parser("PASSIVE RADAR - MULTITARGET TRACKER (PyTorch)",
               modes=("plot", "video", "frames"))
    add_input(p)
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    dev = resolve_device(args.device)

    cf, hist = track(cfg, args.input, dev)
    est = hist["estimate"]                   # (F, N, 2)
    confirmed = hist["status"] == 2          # (F, N)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.mode == "plot":
        fig = plt.figure(figsize=(8, 4.5), dpi=120)
        ax = fig.add_subplot(111)
        cmap = plt.get_cmap("tab10")
        for i in range(N_TRACKS):
            sel = confirmed[:, i]
            if np.any(sel):
                ax.plot(est[sel, i, 1], est[sel, i, 0], ".", ms=4,
                        color=cmap(i % 10), label=f"track {i}")
        ax.set_xlabel("Doppler shift (Hz)")
        ax.set_ylabel("Bistatic range (km)")
        fig.tight_layout()
        fig.savefig("MULTITARGET_PLOT.png")
        plt.close(fig)
        print("Wrote MULTITARGET_PLOT.png")
        return hist

    cmap_colors = [f"C{i}" for i in range(10)]

    def overlay(ax, k):
        artists = []
        lo = max(0, k - TRAIL)
        for i in range(N_TRACKS):
            sel = confirmed[lo:k + 1, i]
            if np.any(sel):
                pts = est[lo:k + 1][sel, i]
                artists.append(ax.plot(pts[:, 1], pts[:, 0], ".",
                                       color=cmap_colors[i % 10], ms=4,
                                       alpha=0.7)[0])
        return artists

    out = render_video(cf, cfg, "MULTITARGET_VIDEO.mp4", overlay=overlay,
                       device=dev)
    print(f"Wrote {out}")
    return hist


if __name__ == "__main__":
    main()
