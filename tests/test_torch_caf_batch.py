"""The port's pipeline.caf_batch against the JAX package's, on the CPU.

TINY geometry (tests/test_pipeline.py). The bound is the port's pipeline
bound, 1e-4 of the map peak with the argmax cell equal in every frame
(tests/test_torch_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.pipeline import caf_batch as j_caf_batch  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_arrays)
from tests.test_torch_pipeline import TINY, _assert_maps_agree  # noqa: E402


def _frames(cfg, n_frames, targets, **kw):
    ref, srv = synth_capture_arrays(cfg, n_frames, targets=targets, **kw)
    n = cfg.input_chunk_length
    return (ref[:n_frames * n].reshape(n_frames, n),
            srv[:n_frames * n].reshape(n_frames, n),
            tp.frame_phases(cfg, list(range(n_frames))))


@pytest.mark.parametrize("overlap_cpi", [True, False])
def test_caf_batch_matches_jax(overlap_cpi):
    """The same IF frames (the port's preprocess and canceller) through
    both packages' caf_batch."""
    params = dict(TINY, overlap_cpi=overlap_cpi)
    cfg_t, cfg_j = t_derive(params), j_derive(params)
    ref, srv, ph = _frames(cfg_t, 4, (Target(40, 20.0, 0.1),), seed=1)
    r_if = tp.preprocess_batch(ref, ph, cfg_t, device="cpu")
    s_if = tp.preprocess_batch(srv, ph, cfg_t, device="cpu")
    clean = tp.clutter_batch(r_if, s_if, cfg_t, device="cpu").numpy()
    r_if = r_if.numpy()
    got = tp.caf_batch(r_if, clean, cfg_t, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.complex64
    assert got.shape == (4, cfg_t.num_doppler_cells,
                         cfg_t.num_range_cells + 1)
    want = np.asarray(j_caf_batch(jnp.asarray(r_if), jnp.asarray(clean),
                                  cfg_j))
    _assert_maps_agree(got.numpy(), want)


def test_caf_batch_composes_to_process_frames():
    """preprocess → clutter_batch → caf_batch is process_frames, exactly."""
    cfg = t_derive(TINY)
    ref, srv, ph = _frames(cfg, 3, (Target(40, 20.0, 0.1),), seed=2)
    r_if = tp.preprocess_batch(ref, ph, cfg, device="cpu")
    s_if = tp.preprocess_batch(srv, ph, cfg, device="cpu")
    got = tp.caf_batch(r_if, tp.clutter_batch(r_if, s_if, cfg, device="cpu"),
                       cfg, device="cpu")
    want = tp.process_frames(ref, srv, ph, cfg, device="cpu")
    assert torch.equal(got, want)


def test_clutter_cancellation_suppresses_direct_path():
    """tests/test_pipeline.py's check on the port: with the canceller, the
    zero-Doppler ridge is more than 30× below caf_batch of the raw IF
    frames."""
    cfg = t_derive(TINY)
    ref, srv, ph = _frames(cfg, 3, (), direct_gain=1.0)
    maps = tp.process_frames(ref, srv, ph, cfg, device="cpu").abs().numpy()
    r_if = tp.preprocess_batch(ref, ph, cfg, device="cpu")
    s_if = tp.preprocess_batch(srv, ph, cfg, device="cpu")
    raw_maps = tp.caf_batch(r_if, s_if, cfg, device="cpu").abs().numpy()
    nf = cfg.num_doppler_cells
    ridge_clean = maps[1, nf // 2 - 1:nf // 2 + 2].max()
    ridge_raw = raw_maps[1, nf // 2 - 1:nf // 2 + 2].max()
    assert ridge_clean < ridge_raw / 30
