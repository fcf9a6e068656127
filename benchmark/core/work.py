"""The work of the port's hand-written kernels, counted from shapes, and
the card's published peaks: the yardstick of the ``*_roofline`` metrics.

Frozen: each count is what the algorithm needs for one launch at the given
shape, whatever implements the kernel (each input byte read once, each
output byte written once). A roofline share is the larger of operations /
``PEAK_FLOPS`` and bytes / ``PEAK_BYTES`` (the least time the card could
take), over the kernel's measured time.

Peaks: NVIDIA H100 SXM5 data sheet, dense, at the full 700 W: 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a launch can take on the card."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def b1_resampler(frames: int, n_in: int, up: int, down: int) -> tuple:
    """B1 (mix + polyphase regroup + matmul): (flops, bytes) of one launch
    over ``frames`` frames of ``n_in`` complex input samples resampled by
    up/down as ``scipy.signal.resample_poly`` designs it (2·10·max(up,
    down) + 1 Kaiser taps, zero-padded to put the output at the centre,
    the input extended by its linear trend).

    Bytes: the float32 IQ input once, the complex64 output (every group of
    ``up`` phases) once, and the bank (its real taps, (up, W) float32, and
    its complex column phasors, W complex64, W = ⌈w / down⌉·down with
    w = ⌈len_h / up⌉ + 1 taps a phase). Operations: 8 a complex
    multiply-add, one per tap a phase and group."""
    half = 10 * max(up, down)
    taps = 2 * half + 1
    pre = down - half % down
    n_out = n_in * up // down + bool((n_in * up) % down)
    len_h = taps + pre
    while ((n_in - 1) * up + len_h - 1) // down + 1 < n_out + (half + pre) \
            // down:
        len_h += 1
    ext = down * (-(-(-(-len_h // up)) // down))        # 'line' extension
    n_full = ((n_in + 2 * ext - 1) * up + len_h - 1) // down + 1
    groups = -(-n_full // up)
    w = -(-len_h // up) + 1
    wp = -(-w // down) * down
    nbytes = frames * n_in * 8 + frames * groups * up * 8 + up * wp * 4 \
        + wp * 8
    flops = 8.0 * frames * groups * taps
    return flops, nbytes


def l1_levinson(systems: int, m: int) -> tuple:
    """L1 (Levinson recursion, first column of T⁻¹): (flops, bytes) of one
    launch over ``systems`` Hermitian Toeplitz systems of order ``m``:
    12·m·(m − 1) + 16·(m − 1) operations a system, its complex64 first
    column read and the solution written."""
    flops = systems * (12.0 * m * (m - 1) + 16.0 * (m - 1))
    return flops, 2 * systems * m * 8


def t1_tracker(channels: int, slots: int, candidates: int) -> tuple:
    """T1 (a multitarget tracker step): (flops, bytes) of one launch: each
    channel's table of ``slots`` tracks (110 float32 a slot) read and
    written, each candidate's range and Doppler (float32) and valid byte
    read; ~16 operations a slot and candidate for its gates and ~400 a
    slot for its Kalman algebra."""
    table = channels * slots * 110 * 4
    nbytes = 2 * table + channels * (2 * candidates * 4 + candidates)
    flops = channels * slots * (16.0 * candidates + 400.0)
    return flops, nbytes
