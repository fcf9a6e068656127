"""Range-Doppler map persistence and metadata (port of
the JAX package's io/writers.py).

The reference's file contract (main.py:200-227): a frame stack of shape
(num_doppler_cells, num_range_cells+1, num_frames) complex64 under '/xambg'
in HDF5 (h5py, imported only for HDF5 output), or a zarr v2 array (the real
``zarr`` package when installed, else io/zarr_min.py, same on-disk format),
plus an .npz with frame_timestamps /
range_bins / doppler_bins axes. The doppler_bins axis has
num_doppler_cells entries centred on zero, except under
cfg.strict_frame_parity, which replicates the reference's doubled axis
(main.py:202-203). ``AbsMapStack`` and ``load_maps`` read a stack back as
float32 magnitudes, for the post-processing CLIs.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from passiveradar_torch.config import RadarConfig


def zarr_backend():
    """The real zarr package when installed, else the vendored subset."""
    if importlib.util.find_spec("zarr") is not None:
        import zarr
        return zarr
    from passiveradar_torch.io import zarr_min
    return zarr_min


def write_metadata(cfg: RadarConfig, num_frames: int, path: str | None = None):
    path = path or cfg.meta_fname
    nf = cfg.num_doppler_cells
    if cfg.strict_frame_parity:
        doppler_bins = np.arange(-nf, nf) * cfg.doppler_cell_width
    else:
        doppler_bins = (np.arange(nf) - nf // 2) * cfg.doppler_cell_width
    np.savez(
        path,
        frame_timestamps=np.arange(num_frames) * cfg.frame_interval,
        range_bins=np.arange(cfg.num_range_cells + 1) * cfg.range_cell_width,
        doppler_bins=doppler_bins,
    )


class MapWriter:
    """Incremental frame-stack writer with resume.

    Progress lives in the output file (a ``frames_done`` attribute advanced
    on contiguous writes), so ``resume=True`` continues an interrupted run.
    """

    def __init__(self, cfg: RadarConfig, num_frames: int,
                 path: str | None = None, resume: bool = False):
        self.cfg = cfg
        self.num_frames = num_frames
        self.path = path or cfg.range_doppler_map_fname
        self.frames_done = 0
        shape = (cfg.num_doppler_cells, cfg.num_range_cells + 1, num_frames)
        chunk = (cfg.num_doppler_cells, cfg.num_range_cells + 1, 1)
        if cfg.range_doppler_map_ftype == "zarr":
            zarr = zarr_backend()
            self._z = zarr.open(self.path, mode="a" if resume else "w",
                                shape=shape, chunks=chunk, dtype=np.complex64)
            if resume:
                self.frames_done = int(self._z.attrs.get("frames_done", 0))
            else:
                self._z.attrs["frames_done"] = 0
            self._h5 = None
        else:
            import h5py
            if resume and os.path.exists(self.path):
                self._h5 = h5py.File(self.path, "a")
                self._d = self._h5["/xambg"]
                self.frames_done = int(self._d.attrs.get("frames_done", 0))
            else:
                self._h5 = h5py.File(self.path, "w")
                self._d = self._h5.create_dataset(
                    "/xambg", shape=shape, dtype=np.complex64, chunks=chunk)
                self._d.attrs["frames_done"] = 0
            self._z = None

    def write(self, frames: np.ndarray, start: int):
        """frames: (F, num_doppler, num_range+1) batch starting at ``start``."""
        block = np.moveaxis(np.asarray(frames, np.complex64), 0, 2)
        target = self._z if self._z is not None else self._d
        target[:, :, start:start + frames.shape[0]] = block
        if start <= self.frames_done:
            self.frames_done = max(self.frames_done, start + frames.shape[0])
            if self._z is not None:
                self._z.attrs["frames_done"] = self.frames_done
            else:
                self._d.attrs["frames_done"] = self.frames_done
                self._h5.flush()

    def close(self):
        if self._h5 is not None:
            self._h5.close()


def _open_maps(cfg: RadarConfig, path: str | None):
    """(dataset, h5py file or None) of a map stack: a zarr array through
    zarr_backend(), or '/xambg' of an HDF5 file (h5py imported here)."""
    path = path or cfg.range_doppler_map_fname
    if cfg.range_doppler_map_ftype == "zarr":
        return zarr_backend().open(path, mode="r"), None
    import h5py
    f = h5py.File(path, "r")
    return f["/xambg"], f


class AbsMapStack:
    """Lazily sliceable |xambg| view over a map file (hdf5 or zarr).

    Exposes ``.shape`` and numpy basic slicing returning float32 magnitudes,
    reading only the requested frames from disk: the streaming renderer's
    input contract (viz/render.iter_display_frames), so a capture-scale
    stack renders at O(chunk) host memory instead of load_maps' O(capture).
    """

    def __init__(self, cfg: RadarConfig, path: str | None = None):
        self._ds, self._h5 = _open_maps(cfg, path)
        self.shape = tuple(self._ds.shape)

    def __getitem__(self, key) -> np.ndarray:
        return np.abs(np.asarray(self._ds[key])).astype(np.float32)

    def close(self):
        if self._h5 is not None:
            self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_maps(cfg: RadarConfig, path: str | None = None) -> np.ndarray:
    """Load the |CAF| frame stack the way the post-processing scripts do
    (reference range_doppler_plot.py:40-48): abs(xambg) as
    (num_doppler, num_range+1, num_frames) float32."""
    with AbsMapStack(cfg, path) as stack:
        return stack[:, :, :]
