"""The arrays of tests/data/h5py_fixture.h5, and the writer that made it.

    python tests/data/make_h5py_fixture.py      (needs h5py)

The fixture is a small HDF5 file that h5py wrote with its default libver:
capture datasets (float32 and int16, separate and interleaved, nested one
level), one chunked float32 dataset filtered by shuffle and deflate, and a
partly written chunked /xambg stack of h5py's complex64 (FRAMES_DONE of
its frames written, the other chunks never allocated, a scalar int64
``frames_done`` attribute). ``fixture_arrays`` regenerates every array
from SEED with numpy alone, so a host without h5py can hold the file to
it (passiveradar_torch/io/hdf5_min.py).
"""

import os

import numpy as np

SEED = 12
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "h5py_fixture.h5")
XAMBG_SHAPE = (16, 9, 6)
FRAMES_DONE = 4
GZIP_CHUNK = 512


def fixture_arrays(seed: int = SEED) -> dict:
    """{dataset path: array} of the fixture; /xambg's unwritten frames are
    zero, the fill value."""
    rng = np.random.default_rng(seed)
    xambg = (rng.standard_normal(XAMBG_SHAPE)
             + 1j * rng.standard_normal(XAMBG_SHAPE)).astype(np.complex64)
    xambg[:, :, FRAMES_DONE:] = 0
    return {
        "/data/ref": rng.standard_normal(2048).astype(np.float32),
        "/data/srv": rng.standard_normal(2048).astype(np.float32),
        "/iq16/data": rng.integers(-32000, 32000, 4096, dtype=np.int16),
        "/gzip/ref": np.round(rng.standard_normal(2048) * 64).astype(
            np.float32),
        "/xambg": xambg,
    }


def write(path: str = PATH, seed: int = SEED) -> None:
    import h5py
    arrays = fixture_arrays(seed)
    with h5py.File(path, "w") as f:
        for key in ("/data/ref", "/data/srv", "/iq16/data"):
            f.create_dataset(key, data=arrays[key])
        f.create_dataset("/gzip/ref", data=arrays["/gzip/ref"],
                         chunks=(GZIP_CHUNK,), compression="gzip",
                         shuffle=True)
        d = f.create_dataset("/xambg", shape=XAMBG_SHAPE, dtype=np.complex64,
                             chunks=XAMBG_SHAPE[:2] + (1,))
        d.attrs["frames_done"] = 0
        d[:, :, :FRAMES_DONE] = arrays["/xambg"][:, :, :FRAMES_DONE]
        d.attrs["frames_done"] = FRAMES_DONE


if __name__ == "__main__":
    write()
    print(PATH, os.path.getsize(PATH), "bytes")
