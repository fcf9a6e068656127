"""The port's persistence, display-frame streaming, CFAR stack and map
loading against the JAX package, on the CPU.

Tolerances: persistence rtol 1e-6 (at most ``hold`` float32 multiply-adds
of positive terms per pixel, in the causal window's order; measured ~2.3e-7
against the JAX convolution); display frames against the port's own
materialised frames exact up to float32 round-off (rtol 1e-6, the same sums
in the same order); CFAR rtol 1e-5 as in tests/test_torch_detect.py; maps
read back exactly.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.cli import plot as jplot  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io import writers as jw  # noqa: E402
from passiveradar_tpu.viz import persistence as j_persistence  # noqa: E402
from passiveradar_tpu.viz import persistence_stack as j_pstack  # noqa: E402
from passiveradar_tpu.viz import render as jr  # noqa: E402
from passiveradar_torch.cli import plot as tplot  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io import writers as tw  # noqa: E402
from passiveradar_torch.viz import persistence as t_persistence  # noqa: E402
from passiveradar_torch.viz import persistence_stack as t_pstack  # noqa: E402
from passiveradar_torch.viz import render as tr  # noqa: E402
from tests.test_cli import TINY  # noqa: E402


@pytest.fixture
def stack():
    """A (doppler, range, frames) stack of positive magnitudes."""
    return np.random.default_rng(5).random((8, 6, 23)).astype(np.float32)


@pytest.mark.parametrize("hold,decay", [(5, 0.9), (20, 0.9), (1, 0.5),
                                        (30, 0.97)])
def test_persistence_stack_matches_jax(stack, hold, decay):
    frames = np.moveaxis(stack, 2, 0)
    want = np.asarray(j_pstack(frames, hold, decay))
    got = t_pstack(torch.from_numpy(frames), hold, decay)
    assert got.dtype == torch.float32 and got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [0, 3, 4, 11, 22])
def test_persistence_frame_matches_jax(stack, k):
    want = np.asarray(j_persistence(stack, k, hold=5, decay=0.9))
    got = t_persistence(stack, k, hold=5, decay=0.9, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    whole = t_pstack(torch.from_numpy(np.moveaxis(stack, 2, 0)),
                     5, 0.9)[k].numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=0)


@pytest.mark.parametrize("hold,decay", [(5, 0.9), (1, 0.5)])
@pytest.mark.parametrize("chunk", [1, 3, 5, 8, 23, 64])
def test_iter_display_frames_exact_across_chunks(stack, chunk, hold, decay):
    """Streamed display frames equal the materialised ones at every chunk
    size, chunks shorter than the hold included (warm-up carry), and the
    JAX package's within the persistence tolerance."""
    want = tr.prepare_display_frames(stack, hold, decay, device="cpu")
    assert want.shape == (23, 6, 8)
    got = np.stack(list(tr.iter_display_frames(stack, hold, decay,
                                               chunk=chunk, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    jax_frames = np.stack(list(jr.iter_display_frames(stack, hold, decay,
                                                      chunk=chunk)))
    np.testing.assert_allclose(got, jax_frames, rtol=1e-6, atol=0)


def test_frame_clim_equal(stack):
    frame = stack[:, :, 0]
    assert tr._frame_clim(frame) == jr._frame_clim(frame)


def test_cfar_stack_and_lazy_cfar_match_jax():
    """cfar_stack against the JAX CLI's, and LazyCFAR's chunk slices
    against the whole stack's CFAR, sliced."""
    x = (np.random.default_rng(9).random((32, 24, 9)) + 0.1).astype(
        np.float32)
    want = np.asarray(jplot.cfar_stack(x, fw=6, gw=2))
    full = tplot.cfar_stack(x, fw=6, gw=2, device="cpu")
    assert full.shape == x.shape and full.dtype == np.float32
    np.testing.assert_allclose(full, want, rtol=1e-5, atol=0)
    lazy = tplot.LazyCFAR(x, fw=6, gw=2, device="cpu")
    assert lazy.shape == x.shape
    got = np.concatenate([lazy[:, :, s:s + 4] for s in range(0, 9, 4)],
                         axis=2)
    np.testing.assert_allclose(got, full, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ftype", ["hdf5", "zarr"])
def test_abs_map_stack_and_load_maps_read_jax_files(tmp_path, ftype):
    """A stack written by the JAX package's MapWriter reads back through
    the port's AbsMapStack (lazily, frame slices) and load_maps, as
    |xambg| float32, equal to the JAX readers'."""
    params = dict(TINY, range_doppler_map_ftype=ftype,
                  output_fname=str(tmp_path / "MAPS"))
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    rng = np.random.default_rng(2)
    shape = (5, cfg_j.num_doppler_cells, cfg_j.num_range_cells + 1)
    maps = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = jw.MapWriter(cfg_j, 5)
    w.write(maps[:3], 0)
    w.write(maps[3:], 3)
    w.close()

    want = jw.load_maps(cfg_j)
    got = tw.load_maps(cfg_t)
    assert got.dtype == np.float32
    assert got.shape == (shape[1], shape[2], 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.abs(np.moveaxis(maps, 0, 2)))
    with tw.AbsMapStack(cfg_t) as lazy, jw.AbsMapStack(cfg_j) as jlazy:
        assert lazy.shape == jlazy.shape == got.shape
        part = lazy[:, :, 1:4]
        assert part.dtype == np.float32
        np.testing.assert_array_equal(part, jlazy[:, :, 1:4])
    # an explicit path reads another stack (a wideband channel's)
    other = str(tmp_path / f"OTHER.{ftype}")
    w = jw.MapWriter(cfg_j, 5, path=other)
    w.write(maps[::-1], 0)
    w.close()
    np.testing.assert_array_equal(tw.load_maps(cfg_t, path=other),
                                  np.abs(np.moveaxis(maps[::-1], 0, 2)))
