"""Range-Doppler map persistence and metadata (port of
the JAX package's io/writers.py).

The reference's file contract (main.py:200-227): a frame stack of shape
(num_doppler_cells, num_range_cells+1, num_frames) complex64 under '/xambg'
in HDF5 (h5py when installed, else io/hdf5_min.py, same on-disk format),
or a zarr v2 array (the real ``zarr`` package when installed, else
io/zarr_min.py, same on-disk format), plus an .npz with frame_timestamps /
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


def hdf5_backend():
    """The real h5py package when installed, else the vendored subset
    (io/hdf5_min.py), which reads and writes the files h5py writes by
    default."""
    if importlib.util.find_spec("h5py") is not None:
        import h5py
        return h5py
    from passiveradar_torch.io import hdf5_min
    return hdf5_min


# frames copied a step when merging part stacks (concat_parts)
CONCAT_SLAB_FRAMES = 64


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
            h5 = hdf5_backend()
            if resume and os.path.exists(self.path):
                self._h5 = h5.File(self.path, "a")
                self._d = self._h5["/xambg"]
                self.frames_done = int(self._d.attrs.get("frames_done", 0))
            else:
                self._h5 = h5.File(self.path, "w")
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


def concat_parts(part_paths, out_path: str, ftype: str = "hdf5") -> int:
    """Concatenate per-process ``.partN`` map stacks into one frame stack.

    Each part holds a contiguous frame range in process order (the
    multi-process output contract, parallel/distributed.py). Frames are
    copied in CONCAT_SLAB_FRAMES-frame slabs, so host memory stays O(slab)
    however large a part is. Sets ``frames_done`` to the total and returns
    it. Zarr stores go through zarr_backend(), HDF5 files through
    hdf5_backend().
    """
    def copy_slabs(dst, src, at: int) -> int:
        n = src.shape[2]
        for s in range(0, n, CONCAT_SLAB_FRAMES):
            e = min(s + CONCAT_SLAB_FRAMES, n)
            dst[:, :, at + s:at + e] = src[:, :, s:e]
        return n

    if ftype == "zarr":
        zarr = zarr_backend()
        srcs = [zarr.open(p, mode="r") for p in part_paths]
        total = sum(s.shape[2] for s in srcs)
        dst = zarr.open(out_path, mode="w",
                        shape=srcs[0].shape[:2] + (total,),
                        chunks=srcs[0].chunks, dtype=srcs[0].dtype)
        at = 0
        for s in srcs:
            at += copy_slabs(dst, s, at)
        dst.attrs["frames_done"] = total
        return total
    h5 = hdf5_backend()
    with h5.File(out_path, "w") as out:
        dst = None
        at = 0
        for p in part_paths:
            with h5.File(p, "r") as f:
                src = f["/xambg"]
                n = src.shape[2]
                if dst is None:
                    dst = out.create_dataset(
                        "/xambg", shape=src.shape[:2] + (n,),
                        maxshape=src.shape[:2] + (None,),
                        dtype=src.dtype, chunks=src.chunks)
                else:
                    dst.resize(at + n, axis=2)
                at += copy_slabs(dst, src, at)
        if dst is not None:
            dst.attrs["frames_done"] = at
    return at


def _open_maps(cfg: RadarConfig, path: str | None):
    """(dataset, HDF5 file or None) of a map stack: a zarr array through
    zarr_backend(), or '/xambg' of an HDF5 file through hdf5_backend()."""
    path = path or cfg.range_doppler_map_fname
    if cfg.range_doppler_map_ftype == "zarr":
        return zarr_backend().open(path, mode="r"), None
    f = hdf5_backend().File(path, "r")
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
