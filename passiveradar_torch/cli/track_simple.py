"""Single-target Kalman tracker CLI (reference simple_kalman_tracker.py).

    python -m passiveradar_torch.cli.track_simple --config cfg.yaml \
        [--mode plot|video|frames] [--input STACK] [--device cpu]

Port of the JAX package's cli/track_simple.py: the map stack is loaded,
CFAR-normalised and tracked on the device (``track``), then plotted to
./TRACKER_PLOT.png or rendered with the locked estimate marked.
"""

from __future__ import annotations

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, \
    fail_on_missing_capture, load, parser
from passiveradar_torch.cli.plot import add_input, cfar_stack
from passiveradar_torch.detect.trackers import simple_target_tracker, to_host
from passiveradar_torch.io.writers import load_maps
from passiveradar_torch.viz.render import render_video


def track(cfg, path: str | None = None, device=None):
    """load_maps → cfar_stack → simple_target_tracker (strict per
    cfg.strict_frame_parity) on ``device`` (default: the CUDA card).
    Returns the CFAR stack (doppler, range, frames) and the tracker's
    history as host arrays with a leading frame axis."""
    dev = resolve_device(device)
    cf = cfar_stack(load_maps(cfg, path=path), device=dev)
    hist = simple_target_tracker(cf, cfg.max_range_actual,
                                 cfg.max_doppler_actual, frames_last=True,
                                 strict=cfg.strict_frame_parity, device=dev)
    return cf, to_host(hist)


@fail_on_missing_capture
def main(argv=None):
    """Returns the tracker's history (host arrays)."""
    p = parser("PASSIVE RADAR - SIMPLE TARGET TRACKER (PyTorch)",
               modes=("plot", "video", "frames"))
    add_input(p)
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    dev = resolve_device(args.device)

    cf, hist = track(cfg, args.input, dev)
    est = hist["estimate"]                   # (F, 2) [range, doppler]
    locked = hist["lock_mode"][:, 2] == 1    # (F,)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.mode == "plot":
        fig = plt.figure(figsize=(8, 4.5), dpi=120)
        ax = fig.add_subplot(111)
        ax.plot(est[~locked, 1], est[~locked, 0], ".", color="0.7",
                ms=3, label="unlocked")
        ax.plot(est[locked, 1], est[locked, 0], "b.", ms=4, label="locked")
        ax.set_xlabel("Doppler shift (Hz)")
        ax.set_ylabel("Bistatic range (km)")
        ax.legend()
        fig.tight_layout()
        fig.savefig("TRACKER_PLOT.png")
        plt.close(fig)
        print("Wrote TRACKER_PLOT.png")
        return hist

    def overlay(ax, k):
        if not locked[k]:
            return []
        return [ax.plot(est[k, 1], est[k, 0], "wo", mfc="none", ms=10)[0]]

    out = render_video(cf, cfg, "TRACKER_VIDEO.mp4", overlay=overlay,
                       device=dev)
    print(f"Wrote {out}")
    return hist


if __name__ == "__main__":
    main()
