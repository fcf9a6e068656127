"""A run whose timed path is broken underneath comes out not correct: each
small cell driven through the harness on the CPU (the look for a card
skipped) with one fault planted in the program: an answer altered where it
is produced, half of a batch left out, a tracker step that returns its
state unchanged. (One card: no exchange between cards to leave out.)"""

import pytest
import torch

from benchmark import control
from benchmark.core import harness
from benchmark.tests import tiny


def _spike(maps):
    """The maps with one cell raised by 5% of each frame's peak."""
    out = maps.clone()
    flat = out.reshape(-1, out.shape[-2] * out.shape[-1])
    flat[:, 7] += 0.05 * flat.abs().amax(dim=1)
    return out


def _halved(maps):
    out = maps.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _fault(monkeypatch, name):
    from passiveradar_torch import pipeline, streaming, wideband
    if name == "fm_altered":
        f = pipeline._caf_batch_impl
        monkeypatch.setattr(pipeline, "_caf_batch_impl",
                            lambda *a, **k: _spike(f(*a, **k)))
    elif name == "fm_half_batch":
        f = pipeline._process_frames_impl
        monkeypatch.setattr(pipeline, "_process_frames_impl",
                            lambda *a, **k: _halved(f(*a, **k)))
    elif name == "stream_altered":
        f = streaming.fast_xambg
        monkeypatch.setattr(streaming, "fast_xambg",
                            lambda *a, **k: _spike(f(*a, **k)[None])[0])
    elif name == "stream_state_unchanged":
        monkeypatch.setattr(streaming, "multitarget_step",
                            lambda tracks, *a, **k: tracks)
    elif name == "wideband_altered":
        f = wideband.channel_caf
        monkeypatch.setattr(wideband, "channel_caf",
                            lambda *a, **k: _spike(f(*a, **k)))
    elif name == "wideband_half_batch":
        f = wideband.wideband_frames
        monkeypatch.setattr(wideband, "wideband_frames",
                            lambda *a, **k: _halved(f(*a, **k)))
    elif name == "wideband_state_unchanged":
        monkeypatch.setattr(wideband, "multitarget_step",
                            lambda tracks, *a, **k: tracks)


CASES = [("tiny_fm_ring", "fm_altered"), ("tiny_fm_ring", "fm_half_batch"),
         ("tiny_fm_stream", "stream_altered"),
         ("tiny_fm_stream", "stream_state_unchanged"),
         ("tiny_wideband_ring", "wideband_altered"),
         ("tiny_wideband_ring", "wideband_half_batch"),
         ("tiny_wideband_stream", "wideband_altered"),
         ("tiny_wideband_stream", "wideband_state_unchanged")]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(copy, monkeypatch, cell, fault):
    _fault(monkeypatch, fault)
    r = harness.run(cell, 11, 0.3, False, device="cpu", root=copy)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(copy, cell):
    r = harness.run(cell, 11, 0.3, False, device="cpu", root=copy)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_judged_by_the_cells_check(copy, cell):
    """The control's state goes through the cell's own check: the
    reference in float64 in the program's place reads correct."""
    from benchmark.core import cells
    from benchmark.reference.precision import FP64
    r = control.judged(cells.find(cell, copy), 11, torch.device("cpu"), FP64)
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] < 1e-6 for c in r["checks"].values()), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fm_ring", "fm_stream", "wideband_stream",
                                  "wideband_ring"])
def test_control_is_not_correct_at_the_cells_size(cell):
    """The control at the cell's own geometry on the card, one seed, a
    small sample, judged by the cell's own check: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.core import cells
    from benchmark.reference.precision import TF32
    c = cells.find(cell)
    c.check.update(control_captures=1, control_pushes=1, control_span=10)
    c.mix.update(keep_positions=[0], seeded_positions=1)
    r = control.judged(c, 7, torch.device("cuda"), TF32)
    assert r["correct"] is False, r["checks"]
