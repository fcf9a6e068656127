"""The frozen work counts pinned to the kernels' counts at the FM and
wideband shapes (PERF.md §6): B1 213 MB, L1 20.6 MFLOP for 50 systems of
m = 185, T1 13,660 B at C = 1, K = 540 and 98,048 B for 8 channels at
K = 384; and the published peaks."""

from benchmark.core import work


def test_b1_bytes_at_the_fm_batch():
    flops, nbytes = work.b1_resampler(10, 2_399_625, 13, 119)
    assert round(nbytes / 1e6) == 213
    assert work.bound_s(flops, nbytes) == nbytes / work.PEAK_BYTES


def test_l1_operations_at_the_fm_batch():
    flops, nbytes = work.l1_levinson(50, 185)
    assert round(flops / 1e5) == 206
    assert nbytes == 148_000
    assert work.bound_s(flops, nbytes) == flops / work.PEAK_FLOPS


def test_t1_bytes_fm_and_wideband():
    assert work.t1_tracker(1, 10, 540)[1] == 13_660
    assert work.t1_tracker(8, 10, 384)[1] == 98_048


def test_peaks():
    assert work.PEAK_FLOPS == 67e12 and work.PEAK_BYTES == 3.35e12
