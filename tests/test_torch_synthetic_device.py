"""The port's io/synthetic.synth_capture_device, on the CPU.

The generator draws its random numbers from a torch.Generator, so its
values differ from the JAX package's jax.random draws; what is held is the
scene: shapes and dtypes, determinism in the seed, the levels of the
direct path, the echoes and the noise, and the target's cell through
process_frames against the JAX generator through the JAX pipeline, at the
TINY geometry (tests/test_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.io.synthetic import \
    synth_capture_device as j_synth_device  # noqa: E402
from passiveradar_tpu.pipeline import frame_phases as j_phases  # noqa: E402
from passiveradar_tpu.pipeline import \
    process_frames as j_process_frames  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_device)
from tests.test_torch_pipeline import TINY  # noqa: E402

TARGETS = (Target(40, 20.0, 0.1), Target(90, -30.0, 0.05))


@pytest.fixture(scope="module")
def cfg():
    return t_derive(TINY)


def _synth(cfg, n_frames=4, **kw):
    kw.setdefault("targets", TARGETS)
    return synth_capture_device(cfg, n_frames, device="cpu", **kw)


def test_shapes_and_dtypes(cfg):
    ref, srv = _synth(cfg, 3, seed=1)
    assert ref.shape == srv.shape == (3, cfg.input_chunk_length)
    assert ref.dtype == srv.dtype == torch.float32
    assert ref.device.type == "cpu"
    cref, csrv = _synth(cfg, 3, seed=1, complex_output=True)
    assert cref.shape == csrv.shape == (3, cfg.input_chunk_length // 2)
    assert cref.dtype == csrv.dtype == torch.complex64
    # the two forms are one stream: interleaved IQ is the complex view
    assert torch.equal(torch.view_as_real(cref).reshape(ref.shape), ref)
    assert torch.equal(torch.view_as_real(csrv).reshape(srv.shape), srv)


def test_seed_determines_the_output(cfg):
    a = _synth(cfg, 2, seed=4)
    b = _synth(cfg, 2, seed=4)
    c = _synth(cfg, 2, seed=5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])


def test_levels(cfg):
    """Constant-envelope reference; srv power = direct_gain² + Σ amp²;
    noise alone has the std noise_level·√2."""
    ref, srv = _synth(cfg, 6, seed=0, complex_output=True)
    assert abs(ref.abs().mean().item() - 1) < 1e-2
    want = 0.5 ** 2 + sum(t.amplitude ** 2 for t in TARGETS)
    assert abs((srv.abs() ** 2).mean().item() / want - 1) < 0.05
    _, noise = _synth(cfg, 6, seed=0, complex_output=True, targets=(),
                      direct_gain=0.0, noise_level=2e-3)
    assert abs(noise.std().item() / (2e-3 * np.sqrt(2)) - 1) < 0.03


def test_default_device_is_the_card(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_capture_device(cfg, 1)


def test_target_cell_matches_jax_pipeline(cfg):
    """The port's generator through the port's process_frames and the JAX
    generator through the JAX pipeline put the target's argmax in the same
    cell in every interior frame, the cell of its delay and Doppler."""
    n_frames = 4
    tg = Target(40, 20.0, 0.1)
    ref, srv = synth_capture_device(cfg, n_frames, targets=(tg,), seed=3,
                                    device="cpu")
    got = tp.process_frames(ref, srv, tp.frame_phases(cfg, range(n_frames)),
                            cfg, device="cpu").abs().numpy()
    cfg_j = j_derive(TINY)
    jref, jsrv = j_synth_device(cfg_j, n_frames, targets=(JTarget(40, 20.0,
                                                                  0.1),),
                                seed=3)
    want = np.abs(np.asarray(j_process_frames(
        jref, jsrv, jnp.asarray(j_phases(cfg_j, list(range(n_frames)))),
        cfg_j)))
    row = cfg.num_doppler_cells // 2 - round(tg.doppler_hz
                                             / cfg.doppler_cell_width)
    col = cfg.num_range_cells - round(tg.delay_samples * cfg.resamp_up
                                      / cfg.resamp_dn)
    for f in range(1, n_frames - 1):
        cell = np.unravel_index(np.argmax(got[f]), got[f].shape)
        assert cell == np.unravel_index(np.argmax(want[f]), want[f].shape)
        assert abs(cell[0] - row) <= 1 and abs(cell[1] - col) <= 1, cell
