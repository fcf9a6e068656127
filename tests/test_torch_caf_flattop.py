"""The flattop CAF, the direct CAF and the explicit-taps decimator of the
port against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its port
counterpart, at the sizes and tolerances of tests/test_caf.py and
tests/test_fir.py.
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

torch.set_num_threads(1)

from passiveradar_tpu.ops import caf as jcaf  # noqa: E402
from passiveradar_tpu.ops import fir as jfir  # noqa: E402
from passiveradar_torch.ops import caf as tcaf  # noqa: E402
from passiveradar_torch.ops import fir as tfir  # noqa: E402


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n,nf,r,window", [(2048, 32, 8, None),
                                           (2048, 32, 8, ("kaiser", 5.0)),
                                           (2048, 64, 40, None),
                                           (1536, 32, 8, None)])
def test_fast_xambg_flattop_matches_jax(rng, n, nf, r, window):
    """short_filt=False against JAX at relative 1e-4: the JAX test's
    geometry (n = 2048, nf = 32, r = 8), windowed, with R + 1 > d (the srv
    windows span several d-rows), and with d = 48 (no power of two)."""
    ref, srv = _cn(rng, n), _cn(rng, n)
    want = np.asarray(jcaf.fast_xambg(ref, srv, r, nf, window=window,
                                      short_filt=False))
    got = tcaf.fast_xambg(_t(ref), _t(srv), r, nf, window=window,
                          short_filt=False).numpy()
    assert got.shape == (nf, r + 1)
    assert _rel(got, want) < 1e-4


def test_fast_xambg_flattop_odd_decimation_matches_jax(rng):
    """d = 45 is odd: the boxcar path refuses it, the flattop one does
    not."""
    n, nf, r = 1440, 32, 8
    ref, srv = _cn(rng, n), _cn(rng, n)
    want = np.asarray(jcaf.fast_xambg(ref, srv, r, nf, short_filt=False))
    got = tcaf.fast_xambg(_t(ref), _t(srv), r, nf, short_filt=False).numpy()
    assert _rel(got, want) < 1e-4


def test_fast_xambg_flattop_batched(rng):
    ref, srv = _cn(rng, 3, 2048), _cn(rng, 3, 2048)
    got = tcaf.fast_xambg(_t(ref), _t(srv), 8, 32, short_filt=False).numpy()
    for f in range(3):
        want = np.asarray(jcaf.fast_xambg(ref[f], srv[f], 8, 32,
                                          short_filt=False))
        assert _rel(got[f], want) < 1e-4


def test_flattop_blocks_reproduce_decimate_taps(rng):
    """The block form of the decimator against scipy.signal.decimate with
    the same taps, for the flattop length and for shorter ones."""
    n, d = 1024, 32
    x = _cn(rng, n).astype(np.complex128)
    for taps in (sps.firwin(10 * d + 1, 1.0 / d, window="flattop"),
                 np.ones(d + 1), rng.standard_normal(3 * d + 4)):
        blocks, pl = tcaf._flattop_blocks(taps, d)
        nc = blocks.shape[0]
        nf = n // d
        xp = np.zeros((nf + nc) * d, np.complex128)
        xp[pl:pl + n] = x[:max(0, min(n, len(xp) - pl))]
        y = xp[:(nf + nc - 1) * d].reshape(-1, d) @ blocks.T.astype(
            np.float64)
        got = sum(y[c:c + nf, c] for c in range(nc))
        want = sps.decimate(x, d, ftype=sps.dlti(taps, 1))[:nf]
        assert _rel(got, want) < 1e-6


def test_direct_xambg_matches_jax(rng):
    n, nf, r, fs = 2048, 16, 10, 2048.0
    ref, srv = _cn(rng, n), _cn(rng, n)
    want = np.asarray(jcaf.direct_xambg(ref, srv, r, nf, fs))
    got = tcaf.direct_xambg(_t(ref), _t(srv), r, nf, fs).numpy()
    assert got.shape == (nf, r + 1)
    assert _rel(got, want) < 1e-4


def test_direct_xambg_agrees_with_fast(rng):
    """tests/test_caf.py's peaks: the direct CAF puts a +3 Hz target at
    nf/2 + 3, the fast one (conjugated srv) at nf/2 − 3, both at lag 4."""
    n, nf, r = 4096, 32, 12
    fs = 4096.0
    ref = _cn(rng, n)
    t = np.arange(n) / fs
    srv = (np.roll(ref, 4) * np.exp(1j * 2 * np.pi * 3.0 * t)).astype(
        np.complex64)
    md = np.abs(tcaf.direct_xambg(_t(ref), _t(srv), r, nf, fs).numpy())
    mf = np.abs(tcaf.fast_xambg(_t(ref), _t(srv), r, nf).numpy())
    assert np.unravel_index(np.argmax(md), md.shape) == (nf // 2 + 3, r - 4)
    assert np.unravel_index(np.argmax(mf), mf.shape) == (nf // 2 - 3, r - 4)


@pytest.mark.parametrize("q,taps", [(64, "ones"), (16, "flattop"),
                                    (5, "random")])
def test_decimate_taps_matches_jax_and_scipy(rng, q, taps):
    n = 4096
    x = _cn(rng, n)
    h = {"ones": np.ones(q + 1),
         "flattop": sps.firwin(10 * q + 1, 1.0 / q, window="flattop"),
         "random": rng.standard_normal(4 * q + 2)}[taps]
    got = tfir.decimate_taps(_t(x), h, q).numpy()
    want = np.asarray(jfir.decimate_taps(x, h, q))
    oracle = sps.decimate(x, q, ftype=sps.dlti(h, 1))
    assert got.shape == want.shape == oracle.shape
    assert _rel(got, want) < 1e-5
    assert _rel(got, oracle) < 1e-5


@pytest.mark.parametrize("up,down,padtype,pairs", [(13, 119, "line", False),
                                                   (1, 3, "constant", True),
                                                   (4, 4, "line", False)])
def test_mix_resample_poly_matches_jax(rng, up, down, padtype, pairs):
    """The single-frame fused mixer-resampler against JAX: complex input
    and (n, 2) IQ pairs, with a phase; 4/4 reduces to the mixer alone."""
    n = 3000
    x = _cn(rng, n)
    arg = np.stack([x.real, x.imag], -1).astype(np.float32) if pairs else x
    want = np.asarray(jfir.mix_resample_poly(arg, -1234.5, 48000.0, 0.7, up,
                                             down, padtype=padtype))
    got = tfir.mix_resample_poly(_t(arg), -1234.5, 48000.0, 0.7, up, down,
                                 padtype=padtype).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5
