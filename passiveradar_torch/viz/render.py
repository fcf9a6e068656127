"""Frame/video rendering of CFAR range-Doppler stacks (counterpart of the JAX
package's viz/render.py).

Mirrors the reference's renderer (range_doppler_plot.py:59-107): persistence
effect, orientation flip, per-frame percentile colour limits (the reference
computes clim inside its render loop, range_doppler_plot.py:84-85), PNG
frames or an mp4 via matplotlib/ffmpeg. Without ffmpeg the video renderer
writes PNG frames instead: that is a choice of encoder, not of device.

Memory: both renderers stream. Frames flow through iter_display_frames in
bounded chunks, the persistence runs on the device chunk by chunk with the
warm-up tail carried across chunk boundaries (exact), and display frames
come back to the host one chunk at a time, so peak host memory is O(chunk),
not O(capture). ``cf`` may be a numpy array or any lazily sliceable
(H, W, F) stack (an h5py dataset, a zarr array, cli.plot.LazyCFAR).
matplotlib is imported inside the rendering calls only.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.viz.persistence import persistence_stack

# frames per streamed device chunk; the carried warm-up tail adds hold-1
RENDER_CHUNK_FRAMES = 64


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _to_display(stack: torch.Tensor) -> np.ndarray:
    """(F, nf, nr) persistence output → (F, range, doppler) display frames
    on the host (the reference's fliplr(frame.T),
    range_doppler_plot.py:73)."""
    return torch.flip(stack.transpose(1, 2), dims=(2,)).cpu().numpy()


def iter_display_frames(cf, hold: int = 20, decay: float = 0.90,
                        chunk: int = RENDER_CHUNK_FRAMES, device=None):
    """Yield display frames of a (doppler, range, frames) stack one by one.

    ``cf`` needs only ``.shape`` and basic slicing ``cf[:, :, s:e]``, so the
    stack streams straight from disk. Each chunk goes to ``device``
    (default: the CUDA card) with the previous ``hold-1`` raw frames
    prepended as warm-up, whose outputs are dropped: persistence is exact
    across chunk boundaries.
    """
    dev = resolve_device(device)
    total = cf.shape[2]
    tail = None                                        # last hold-1 raw frames
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        block = on_device(np.moveaxis(np.asarray(cf[:, :, s:e], np.float32),
                                      2, 0), dev)
        warm = 0
        if tail is not None and hold > 1:
            warm = tail.shape[0]
            block = torch.cat([tail, block], dim=0)
        out = persistence_stack(block, hold, decay)[warm:]
        if hold > 1:
            tail = block[-(hold - 1):]
        yield from _to_display(out)


def prepare_display_frames(cf, hold: int = 20, decay: float = 0.90,
                           device=None) -> np.ndarray:
    """|CAF|/CFAR stack (doppler, range, frames) → display frames
    (frames, range, doppler) with persistence applied, computed on
    ``device``. Materialises the full stack; use iter_display_frames for
    capture-scale rendering."""
    frames = on_device(np.moveaxis(np.asarray(cf[:, :, :], np.float32), 2, 0),
                       resolve_device(device))
    return _to_display(persistence_stack(frames, hold, decay))


def _frame_clim(frame: np.ndarray) -> tuple[float, float]:
    """Per-frame colour limits, the reference's exact ad-hoc values
    (range_doppler_plot.py:84-85): vmin = 35th percentile,
    vmax = 1.5 x 99th percentile, recomputed per displayed frame."""
    return (float(np.percentile(frame, 35)),
            1.5 * float(np.percentile(frame, 99)))


def _setup_axes(ax, cfg: RadarConfig):
    ax.set_xlabel("Doppler shift (Hz)")
    ax.set_ylabel("Bistatic range (km)")


def render_frames(cf, cfg: RadarConfig, out_dir: str = "IMG",
                  hold: int = 20, decay: float = 0.90, prefix: str = "img",
                  device=None):
    """Save per-frame PNGs (reference range_doppler_plot.py --mode frames)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    extent = [-cfg.max_doppler_actual, cfg.max_doppler_actual,
              0, cfg.max_range_actual]
    for k, frame in enumerate(iter_display_frames(cf, hold, decay,
                                                  device=device)):
        vmin, vmax = _frame_clim(frame)
        fig = plt.figure(figsize=(8, 4.5), dpi=120)
        ax = fig.add_subplot(111)
        # row 0 of the display frame is MAXIMUM range (the reference's
        # linspace(extent, 0) convention): origin='upper' puts it on top
        ax.imshow(frame, cmap="gnuplot2", vmin=vmin, vmax=vmax,
                  extent=extent, aspect="auto")
        _setup_axes(ax, cfg)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{prefix}_{k:04d}.png"))
        plt.close(fig)
    return out_dir


def render_video(cf, cfg: RadarConfig, out_path: str, hold: int = 20,
                 decay: float = 0.90, fps: int = 25, overlay=None,
                 device=None):
    """Render an mp4 (reference --mode video); PNG frames when ffmpeg is
    unavailable. ``overlay(ax, k)`` may draw per-frame extras (tracker
    markers) and returns the artists to remove before the next frame."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    if not has_ffmpeg():
        out_dir = os.path.splitext(out_path)[0] + "_frames"
        print(f"ffmpeg not found; writing PNG frames to {out_dir}/ instead")
        return render_frames(cf, cfg, out_dir, hold, decay, device=device)

    extent = [-cfg.max_doppler_actual, cfg.max_doppler_actual,
              0, cfg.max_range_actual]
    fig = plt.figure(figsize=(8, 4.5), dpi=120)
    ax = fig.add_subplot(111)
    im = None
    artists = []
    writer = animation.FFMpegWriter(fps=fps)
    # frames go straight into the encoder (grab_frame); per-frame clim uses
    # the reference's in-loop percentile limits (_frame_clim)
    with writer.saving(fig, out_path, fig.dpi):
        for k, frame in enumerate(iter_display_frames(cf, hold, decay,
                                                      device=device)):
            vmin, vmax = _frame_clim(frame)
            if im is None:
                im = ax.imshow(frame, cmap="gnuplot2", vmin=vmin, vmax=vmax,
                               extent=extent, aspect="auto")
                _setup_axes(ax, cfg)
            else:
                im.set_data(frame)
                im.set_clim(vmin, vmax)
            for a in artists:
                a.remove()
            artists.clear()
            if overlay is not None:
                artists.extend(overlay(ax, k) or [])
            writer.grab_frame()
    plt.close(fig)
    return out_path
