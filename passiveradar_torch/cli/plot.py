"""Range-Doppler video/frames renderer (reference range_doppler_plot.py).

    python -m passiveradar_torch.cli.plot --config cfg.yaml \
        [--mode video|frames] [--input STACK] [--device cpu]

Port of the JAX package's cli/plot.py. The disk → PNG/mp4 path streams end
to end: maps are read lazily (io.writers.AbsMapStack), CFAR runs on the
device per rendered chunk (LazyCFAR), and the renderer never materialises
the display stack (viz/render.iter_display_frames): peak host memory is
O(render chunk) at any capture length. PNGs go to ./IMG and the video to
./RADAR_VIDEO.mp4, in the working directory.
"""

from __future__ import annotations

import numpy as np

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.cli.common import add_device, \
    fail_on_missing_capture, load, parser
from passiveradar_torch.io.writers import AbsMapStack
from passiveradar_torch.ops.cfar import cfar_2d
from passiveradar_torch.viz.render import render_frames, render_video


def cfar_stack(xambg: np.ndarray, fw: int = 18, gw: int = 4,
               device=None) -> np.ndarray:
    """CFAR-normalise every frame of a (doppler, range, frames) |CAF| stack
    (reference range_doppler_plot.py:54-57), batched on ``device`` (default:
    the CUDA card) over the frames-first view. Returns numpy in the input's
    layout."""
    frames = on_device(np.moveaxis(np.asarray(xambg, np.float32), 2, 0),
                       resolve_device(device))
    cf = cfar_2d(frames, fw, gw).cpu().numpy()
    return np.moveaxis(cf, 0, 2)


class LazyCFAR:
    """Per-slice CFAR view over a lazily sliceable (H, W, F) |CAF| stack.

    Exact: CFAR is per frame, so slicing then normalising equals
    normalising the whole stack then slicing. Feed it to the streaming
    renderer to keep disk → video memory bounded.
    """

    def __init__(self, stack, fw: int = 18, gw: int = 4, device=None):
        self._stack = stack
        self._fw, self._gw = fw, gw
        self._dev = resolve_device(device)
        self.shape = stack.shape

    def __getitem__(self, key) -> np.ndarray:
        return cfar_stack(self._stack[key], self._fw, self._gw, self._dev)


def add_input(p) -> None:
    p.add_argument("--input", default=None,
                   help="Map-stack path to read instead of the config's "
                        "default output, e.g. a wideband per-channel stack "
                        "(<output>.chK.<ftype>) or the --integrate stack "
                        "(<output>.integrated.<ftype>)")


@fail_on_missing_capture
def main(argv=None):
    """Returns the path written (the PNG directory or the video)."""
    p = parser("PASSIVE RADAR - VIDEO RENDERER (PyTorch)",
               modes=("video", "frames"))
    add_input(p)
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    dev = resolve_device(args.device)

    with AbsMapStack(cfg, path=args.input) as xambg:
        print(f"Rendering range-Doppler maps {xambg.shape} (streamed, "
              f"{dev})")
        cf = LazyCFAR(xambg, device=dev)
        if args.mode == "frames":
            out = render_frames(cf, cfg, device=dev)
        else:
            out = render_video(cf, cfg, "RADAR_VIDEO.mp4", device=dev)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
