"""Card-only checks of the port: the CUDA kernel against its plain version,
and the whole chain on the card against the CPU.

Marked ``cuda``; each test skips when no CUDA card is present (decided in
the fixture, at run time). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_torch.config import derive_config  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_arrays)
from passiveradar_torch.ops import resample_kernel as rk  # noqa: E402
from passiveradar_torch.pipeline import frame_phases, process_frames  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("up,down,frames", [(13, 119, 3), (1, 3, 2),
                                            (3, 17, 11), (20, 21, 2)])
def test_mix_regroup_kernel_matches_plain(cuda, up, down, frames):
    """Kernel vs its plain version on the same card tensors, across phase
    counts (template instantiations), ragged group tiles and left pads."""
    gen = torch.Generator(device=cuda).manual_seed(up * 1000 + down)
    w = 3 * down
    n = down * 150 + 7
    pad = down + 5
    groups = (n + pad - w) // down + 3
    x = torch.randn((frames, n, 2), generator=gen, device=cuda)
    bank = rk.pack_bank(torch.randn((2 * up, w), generator=gen, device=cuda),
                        up)
    before = rk.mix_regroup_matmul.launches
    got = rk.mix_regroup_matmul(x, bank, down, groups, up, pad)
    assert rk.mix_regroup_matmul.launches == before + 1
    want = rk.mix_regroup_matmul_plain(x, bank, down, groups, up, pad)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= 2e-6 * peak


@pytest.mark.cuda
def test_mix_regroup_kernel_rejects_cpu_bank(cuda):
    x = torch.zeros((1, 100, 2), device=cuda)
    with pytest.raises(ValueError, match="same device"):
        rk.mix_regroup_matmul(x, torch.zeros((9, 2, 2)), 3, 30, 1)


@pytest.mark.cuda
def test_process_frames_card_matches_cpu(cuda):
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0,
                             max_doppler_nominal=128.0,
                             max_range_nominal=400.0))
    nfr = 4
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    length = cfg.input_chunk_length
    ref = ref[:nfr * length].reshape(nfr, length)
    srv = srv[:nfr * length].reshape(nfr, length)
    ph = frame_phases(cfg, list(range(nfr)))
    got = process_frames(ref, srv, ph, cfg).cpu().numpy()
    want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))
    for f in range(nfr):
        assert np.argmax(np.abs(got[f])) == np.argmax(np.abs(want[f]))
