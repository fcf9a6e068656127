"""The work of B2, the port's NLMS kernel (``csrc/nlms.cu``), counted from
shapes: the yardstick of ``b2_roofline.capture``, frozen as
``core/work.py``'s counts are (the card's peaks are there).

Each of the n − m steps of a frame takes one complex dot product wᴴu and
one rank-1 tap update over m taps, 8 operations a complex multiply-add
each; ref and srv are read once and the output written once, complex64."""

from __future__ import annotations


def b2_nlms(frames: int, n: int, m: int) -> tuple:
    """(flops, bytes) of one launch over ``frames`` frames of ``n``
    samples with m = filter_len + peek taps: 16·m·(n − m) operations a
    frame, 3·n·8 bytes."""
    return 16.0 * m * (n - m) * frames, 3 * frames * n * 8
