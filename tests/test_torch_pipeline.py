"""The port's frame pipeline and CLI against the JAX package, on the CPU.

TINY geometry (copied from tests/test_pipeline.py): cpi 16384 samples, a
1/3 resample, 256 Doppler × 23 range cells. The bound is 1e-4 of the map
peak with the argmax cell equal in every frame (the golden pipeline bound
is 2e-3; the port's whole chain, clutter included, stays far inside it).
"""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.io.synthetic import synth_capture_arrays  # noqa: E402
from passiveradar_tpu.pipeline import \
    frame_phases as j_frame_phases  # noqa: E402
from passiveradar_tpu.pipeline import \
    process_frames as j_process_frames  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, write_synth_capture)
from passiveradar_torch.io.synthetic import \
    synth_capture_arrays as t_synth  # noqa: E402

TINY = dict(
    input_file="",
    input_ref_path="/data/ref",
    input_srv_path="/data/srv",
    range_doppler_map_ftype="hdf5",
    output_fname="tiny_maps",
    num_frames=8,
    input_sample_rate=49152,
    input_center_freq=1_000_000,
    channel_freq=990_170,        # offset 9830 → nonzero per-frame phases
    channel_bandwidth=12800,
    cpi_seconds_nominal=1.0,
    max_doppler_nominal=128.0,
    max_range_nominal=400.0,
    overlap_cpi=True,
    frame_batch=4,
)
TOL = 1e-4


def _assert_maps_agree(got, want):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) < TOL * np.max(np.abs(want))
    for f in range(want.shape[0]):
        assert (np.unravel_index(np.argmax(np.abs(got[f])), got[f].shape)
                == np.unravel_index(np.argmax(np.abs(want[f])),
                                    want[f].shape)), f


def _assert_maps_agree_nan(got, want):
    """Equal NaN masks; the frames that are finite agree as above."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = [f for f in range(want.shape[0]) if np.isfinite(want[f]).all()]
    assert finite
    _assert_maps_agree(got[finite], want[finite])


def test_config_derivation_equal():
    for params in (TINY, dict(TINY, overlap_cpi=False),
                   dict(TINY, input_sample_rate=2_400_000,
                        input_center_freq=102_000_000,
                        channel_freq=101_900_000, channel_bandwidth=200_000,
                        cpi_seconds_nominal=2.0, max_doppler_nominal=256.0,
                        max_range_nominal=200.0)):
        assert t_derive(params).as_dict() == j_derive(params).as_dict()


def test_synth_capture_arrays_equal():
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    tg = (40, 20.0, 0.1)
    a = synth_capture_arrays(cfg_j, 2, targets=(JTarget(*tg),), seed=3,
                             channel_offset=5)
    b = t_synth(cfg_t, 2, targets=(Target(*tg),), seed=3, channel_offset=5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_frame_phases_equal():
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    idx = [0, 3, 4, 9]
    np.testing.assert_array_equal(tp.frame_phases(cfg_t, idx),
                                  j_frame_phases(cfg_j, idx))


@pytest.mark.parametrize("layout", ["interleaved", "pairs"])
def test_process_frames_matches_jax(layout):
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    n_frames = 4
    ref, srv = synth_capture_arrays(
        cfg_j, n_frames, targets=(JTarget(40, 20.0, 0.1),), seed=0)
    L = cfg_j.input_chunk_length
    ref = ref[:n_frames * L].reshape(n_frames, L)
    srv = srv[:n_frames * L].reshape(n_frames, L)
    phases = j_frame_phases(cfg_j, list(range(n_frames)))
    want = np.asarray(j_process_frames(jnp.asarray(ref), jnp.asarray(srv),
                                       jnp.asarray(phases), cfg_j))
    if layout == "pairs":
        ref = ref.reshape(n_frames, L // 2, 2)
        srv = srv.reshape(n_frames, L // 2, 2)
    got = tp.process_frames(ref, srv, phases, cfg_t, device="cpu").numpy()
    _assert_maps_agree(got, want)


def test_int16_preprocess_matches_float(rng):
    """int16 pairs × int16_scale equal the host-converted float32 path."""
    cfg = t_derive(dict(TINY, int16_scale=1 / 4096))
    raw = rng.integers(-3000, 3000, (2, cfg.input_chunk_length // 2, 2),
                       dtype=np.int16)
    ph = np.zeros(2, np.float32)
    a = tp.preprocess_batch(raw, ph, cfg, device="cpu")
    b = tp.preprocess_batch(raw.astype(np.float32) * np.float32(1 / 4096), ph,
                            cfg, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == (2, cfg.output_chunk_length)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_cli")
    params = dict(TINY, num_frames=6)
    params["input_file"] = str(ws / "cap.hdf5")
    params["output_fname"] = str(ws / "XAMBG_T")
    cfg = t_derive(params)
    write_synth_capture(params["input_file"], cfg, 6,
                        targets=(Target(40, 20.0, 0.12),), channel_offset=3)
    cfg_path = ws / "config.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(params, f)
    jparams = dict(params, output_fname=str(ws / "XAMBG_J"))
    jcfg_path = ws / "config_jax.yaml"
    with open(jcfg_path, "w") as f:
        yaml.safe_dump(jparams, f)
    return ws, str(cfg_path), str(jcfg_path), cfg


def _xambg(path):
    with h5py.File(path, "r") as f:
        return np.asarray(f["/xambg"]), int(f["/xambg"].attrs["frames_done"])


def test_cli_end_to_end_matches_jax(workspace):
    """Both CLIs on one capture (3-sample channel offset, two batches of the
    4-frame batch size): /xambg stacks and npz axes agree."""
    ws, cfg_path, jcfg_path, cfg = workspace
    from passiveradar_torch.cli.process import main as t_main
    from passiveradar_tpu.cli.process import main as j_main
    assert t_main(["--config", cfg_path, "--device", "cpu"]) == 6
    j_main(["--config", jcfg_path])
    got, done_t = _xambg(str(ws / "XAMBG_T.hdf5"))
    want, done_j = _xambg(str(ws / "XAMBG_J.hdf5"))
    assert done_t == done_j == 6
    assert got.shape == (cfg.num_doppler_cells, cfg.num_range_cells + 1, 6)
    _assert_maps_agree(np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0))
    mt = np.load(str(ws / "XAMBG_T.npz"))
    mj = np.load(str(ws / "XAMBG_J.npz"))
    for key in ("frame_timestamps", "range_bins", "doppler_bins"):
        np.testing.assert_array_equal(mt[key], mj[key])


def test_cli_strict_frame_parity_matches_jax(workspace):
    """strict_frame_parity: one frame fewer, a zero right halo on the last
    frame, the doubled doppler_bins axis — as the JAX CLI writes them."""
    ws, cfg_path, _, cfg = workspace
    from passiveradar_torch.cli.process import main as t_main
    from passiveradar_tpu.cli.process import main as j_main
    params = yaml.safe_load(open(cfg_path))
    paths = {}
    for tag in ("T", "J"):
        p = dict(params, strict_frame_parity=True,
                 output_fname=str(ws / f"STRICT_{tag}"))
        paths[tag] = ws / f"strict_{tag}.yaml"
        paths[tag].write_text(yaml.safe_dump(p))
    assert t_main(["--config", str(paths["T"]), "--device", "cpu"]) == 5
    j_main(["--config", str(paths["J"])])
    got, _ = _xambg(str(ws / "STRICT_T.hdf5"))
    want, _ = _xambg(str(ws / "STRICT_J.hdf5"))
    assert got.shape[2] == 5
    _assert_maps_agree(np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0))
    axes_t = np.load(str(ws / "STRICT_T.npz"))
    axes_j = np.load(str(ws / "STRICT_J.npz"))
    np.testing.assert_array_equal(axes_t["doppler_bins"],
                                  axes_j["doppler_bins"])


def test_cli_resume_continues_from_frames_done(workspace):
    """--resume after a run cut at frames_done = 4 recomputes only the rest
    and lands on the same stack as the uninterrupted run."""
    ws, cfg_path, _, cfg = workspace
    from passiveradar_torch.cli.process import main as t_main
    path = str(ws / "XAMBG_T.hdf5")
    if not os.path.exists(path):
        t_main(["--config", cfg_path, "--device", "cpu"])
    full, _ = _xambg(path)
    with h5py.File(path, "a") as f:
        d = f["/xambg"]
        d[:, :, 4:] = 0
        d.attrs["frames_done"] = 4
    t_main(["--config", cfg_path, "--device", "cpu", "--resume"])
    resumed, done = _xambg(path)
    assert done == 6
    np.testing.assert_array_equal(resumed, full)


def test_cli_zarr_capture_and_maps_match_hdf5(workspace):
    """The same capture as a zarr directory store, with zarr map output
    (the route for hosts without h5py), gives the HDF5 run's stack."""
    ws, cfg_path, _, cfg = workspace
    from passiveradar_torch.cli.process import main as t_main
    from passiveradar_torch.io import zarr_min
    params = yaml.safe_load(open(cfg_path))
    params.update(input_file=str(ws / "cap.zarr"),
                  output_fname=str(ws / "XAMBG_Z"),
                  range_doppler_map_ftype="zarr")
    write_synth_capture(params["input_file"], t_derive(params), 6,
                        targets=(Target(40, 20.0, 0.12),), channel_offset=3)
    zcfg = ws / "config_zarr.yaml"
    zcfg.write_text(yaml.safe_dump(params))
    path = str(ws / "XAMBG_T.hdf5")
    if not os.path.exists(path):
        t_main(["--config", cfg_path, "--device", "cpu"])
    assert t_main(["--config", str(zcfg), "--device", "cpu"]) == 6
    got = zarr_min.open(str(ws / "XAMBG_Z.zarr"), mode="r")
    assert got.attrs["frames_done"] == 6
    want, _ = _xambg(path)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.max(np.abs(want)))


def test_cli_rejects_flags_not_ported(workspace):
    """Every flag of the JAX CLI is ported now: --shard (a mesh of the one
    CPU device here) with --dispatch-groups writes the plain run's stack;
    what is refused is a flag the JAX CLI lacks, or fewer than 1 group."""
    ws, cfg_path, _, _ = workspace
    from passiveradar_torch.cli.process import main as t_main
    for extra in (["--dispatch-groups", "0"], ["--no-such-flag"]):
        with pytest.raises(SystemExit):
            t_main(["--config", cfg_path, "--device", "cpu"] + extra)
    path = str(ws / "XAMBG_T.hdf5")
    if not os.path.exists(path):
        t_main(["--config", cfg_path, "--device", "cpu"])
    want, _ = _xambg(path)
    params = yaml.safe_load(open(cfg_path))
    params["output_fname"] = str(ws / "XAMBG_FLAGS")
    flags_cfg = ws / "config_flags.yaml"
    flags_cfg.write_text(yaml.safe_dump(params))
    for extra in (["--shard"], ["--dispatch-groups", "2"]):
        assert t_main(["--config", str(flags_cfg), "--device", "cpu"]
                      + extra) == 6
        got, done = _xambg(str(ws / "XAMBG_FLAGS.hdf5"))
        assert done == 6
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("method", ["nlms", "nlms_pallas"])
def test_process_frames_nlms_matches_jax(method):
    """Both NLMS methods against the JAX pipeline, with zero frames at both
    edges of the batch (as run_capture's margins give). Under 'nlms' the
    JAX scan turns a zero frame into NaN and the CPI-overlap halo carries it
    to its neighbours: frames 0, 1, 4 and 5 are NaN maps, 2 and 3 finite,
    and the port gives the same mask. Under 'nlms_pallas' all are finite."""
    params = dict(TINY, clutter_method=method)
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    n_frames = 6
    ref, srv = synth_capture_arrays(
        cfg_j, n_frames, targets=(JTarget(40, 20.0, 0.1),), seed=1)
    L = cfg_j.input_chunk_length
    ref = ref[:n_frames * L].reshape(n_frames, L)
    srv = srv[:n_frames * L].reshape(n_frames, L)
    ref[[0, -1]] = 0
    srv[[0, -1]] = 0
    phases = j_frame_phases(cfg_j, list(range(n_frames)))
    want = np.asarray(j_process_frames(jnp.asarray(ref), jnp.asarray(srv),
                                       jnp.asarray(phases), cfg_j))
    got = tp.process_frames(ref, srv, phases, cfg_t, device="cpu").numpy()
    if method == "nlms":
        nan_frames = [f for f in range(n_frames) if np.isnan(want[f]).any()]
        assert nan_frames == [0, 1, 4, 5]
        _assert_maps_agree_nan(got, want)
    else:
        _assert_maps_agree(got, want)


@pytest.mark.parametrize("method", ["nlms", "nlms_pallas"])
def test_cli_nlms_matches_jax(workspace, method):
    """Both CLIs with an NLMS clutter method on one capture. run_capture
    feeds a zero frame before the capture's first frame, so under 'nlms'
    both write a NaN map for frame 0 (the capture holds a frame after the
    last one written, which is read as the right margin)."""
    ws, cfg_path, _, cfg = workspace
    from passiveradar_torch.cli.process import main as t_main
    from passiveradar_tpu.cli.process import main as j_main
    params = yaml.safe_load(open(cfg_path))
    paths = {}
    for tag in ("T", "J"):
        p = dict(params, clutter_method=method,
                 output_fname=str(ws / f"{method}_{tag}"))
        paths[tag] = ws / f"{method}_{tag}.yaml"
        paths[tag].write_text(yaml.safe_dump(p))
    assert t_main(["--config", str(paths["T"]), "--device", "cpu"]) == 6
    j_main(["--config", str(paths["J"])])
    got, done_t = _xambg(str(ws / f"{method}_T.hdf5"))
    want, done_j = _xambg(str(ws / f"{method}_J.hdf5"))
    assert done_t == done_j == 6
    got, want = np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0)
    if method == "nlms":
        nan_frames = [f for f in range(6) if np.isnan(want[f]).any()]
        assert nan_frames == [0]
        _assert_maps_agree_nan(got, want)
    else:
        _assert_maps_agree(got, want)


def test_clutter_rejects_unknown_method():
    cfg = t_derive(dict(TINY, clutter_method="lms"))
    x = torch.zeros((1, 100), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown clutter_method"):
        tp._clutter_impl(x, x, cfg)


# ---- run_capture's card feed: its plan and host side (feed.py) --------------

class _PairFrames:
    """A capture of ``n`` frames of (lc, 2) IQ pairs read as run_capture
    reads it, with one frame before frame 0 (a sharded reader's margin)
    and one after the last; every sample distinct. ``ref`` and ``srv``
    differ."""

    def __init__(self, n, lc=5, dtype=np.int16, before=False, after=False):
        self.num_frames = n
        self.pair_dtype = np.dtype(dtype)
        self.frame_margin_before = before
        self.frame_margin_after = after
        base = np.arange((n + 2) * lc * 2).reshape(n + 2, lc, 2) + 1
        self.ref = base.astype(dtype)
        self.srv = (-base).astype(dtype)

    def read_pair_frames(self, start, count):
        a = start + 1
        return self.ref[a:a + count], self.srv[a:a + count]


def _buffers_before(reader, cfg, bf, done):
    """The (bf + 2)-slot buffers of each batch as run_capture assembled
    them in host buffers before the card feed: (start, count, ref, srv)."""
    total = min(reader.num_frames, cfg.num_frames)
    if cfg.strict_frame_parity and total > 0:
        total -= 1
    margin_lo = reader.frame_margin_before
    margin_hi = reader.frame_margin_after or (
        total < reader.num_frames and not cfg.strict_frame_parity)
    out = []
    while done < total:
        count = min(bf, total - done)
        lo = done - 1 if (done > 0 or margin_lo) else 0
        hi = min(total + (1 if margin_hi else 0), done + count + 1)
        slot0 = 1 - (done - lo)
        bufs = []
        for raw in reader.read_pair_frames(lo, hi - lo):
            buf = np.zeros((bf + 2,) + raw.shape[1:], raw.dtype)
            buf[slot0:slot0 + hi - lo] = raw
            bufs.append(buf)
        out.append((done, count, *bufs))
        done += count
    return out


def _feed_delta(before):
    from passiveradar_torch import feed
    return {k: v - before[k] for k, v in feed.stage_info().items()}


@pytest.mark.parametrize("bf", [1, 3, 8])
@pytest.mark.parametrize("total", ["1", "bf-1", "bf", "bf+1", "3bf+2"])
def test_feed_plan_assembles_the_buffers_as_before(monkeypatch, bf, total):
    """The card feed's plan (slots reused on the card, frames read from the
    host, zero slots), staged through feed.CardFeed on CPU tensors, gives
    every batch the buffer that the host loop assembled before, on fresh
    and resumed runs, with and without a sharded reader's margins, a frame
    past the run, and strict_frame_parity; the host reads each frame
    once."""
    from types import SimpleNamespace

    from passiveradar_torch import feed
    monkeypatch.setattr(feed, "CHUNK_BYTES", 7)
    total = {"1": 1, "bf-1": bf - 1, "bf": bf, "bf+1": bf + 1,
             "3bf+2": 3 * bf + 2}[total]
    lc = 5
    for resume, before, after, extra, strict in np.ndindex(2, 2, 2, 2, 2):
        done = total // 2 if resume else 0
        cfg = SimpleNamespace(num_frames=total + strict,
                              strict_frame_parity=bool(strict))
        reader = _PairFrames(total + strict + extra, lc, before=bool(before),
                             after=bool(after))
        writer = SimpleNamespace(frames_done=done)
        want = _buffers_before(reader, cfg, bf, done)
        n, batches = tp.capture_batches(reader, writer, cfg, bf)
        assert n == total
        assert [(b.start, b.count) for b in batches] == \
            [w[:2] for w in want]
        assert [b.reuse for b in batches] == \
            [0] + [2] * (len(batches) - 1) if batches else total == 0
        # the reads tile the frames the buffers hold: each is read once
        reads = [b.read for b in batches]
        for (a, k), (a2, _) in zip(reads, reads[1:]):
            assert a + k == a2
        counted = feed.stage_info()
        card = feed.CardFeed(bf + 2, lc, torch.int16, torch.device("cpu"))
        for b, (_, _, ref, srv) in zip(batches, want):
            got = card.stage(b, reader.read_pair_frames(*b.read))
            card.consumed()
            np.testing.assert_array_equal(got[0].numpy(), ref)
            np.testing.assert_array_equal(got[1].numpy(), srv)
        card.close()
        held = sum(b.hi - b.lo for b in batches)
        assert _feed_delta(counted) == dict(
            calls=1, batches=len(batches),
            frames_sent=2 * sum(k for _, k in reads),
            frames_reused=2 * 2 * max(len(batches) - 1, 0),
            frames_zeroed=2 * ((bf + 2) * len(batches) - held),
            bytes_sent=2 * sum(k for _, k in reads) * lc * 2 * 2,
            chunks=2 * sum(-(-k * lc * 4 // 7) for _, k in reads),
            slot_waits=0)


def _frames_of(dtype, n, lc, seed):
    """``n`` frames of IQ as a reader gives them: int16 or float32 pairs
    (n, lc, 2), or complex64 (n, lc)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-30000, 30000, size=(n, lc, 2))
    if dtype == "int16":
        return x.astype(np.int16)
    x = x.astype(np.float32) / 7
    return x if dtype == "float32" else \
        x.view(np.complex64).reshape(n, lc)


@pytest.mark.parametrize("dtype", ["int16", "float32", "complex64"])
@pytest.mark.parametrize("chunk_bytes", [7, 27, 100])
@pytest.mark.parametrize("layout", ["contiguous", "strided_frames",
                                    "column_major", "read_only"])
def test_chunk_stager_lands_the_bytes(monkeypatch, dtype, chunk_bytes,
                                      layout):
    """The stager's host side on a CPU target (no events): chunk sizes that
    do not divide a frame (20 or 40 bytes), int16 and float32 pairs and
    complex64 viewed as float32 pairs, a contiguous source, two that are
    not (frames apart; frames not contiguous themselves) and a read-only
    one (as ``np.frombuffer`` gives, read without a warning); the bytes
    land exactly and the counters add up."""
    import warnings

    from passiveradar_torch import feed
    monkeypatch.setattr(feed, "CHUNK_BYTES", chunk_bytes)
    lc, bf, total = 5, 3, 10
    step = 2 if layout == "strided_frames" else 1
    chans = [_frames_of(dtype, step * (total + 1), lc, seed)[::step]
             for seed in (chunk_bytes, chunk_bytes + 1)]
    if layout == "column_major":
        chans = [np.asfortranarray(x) for x in chans]
    for x in chans:
        x.flags.writeable = layout != "read_only"
    assert chans[0].flags.c_contiguous == (layout in ("contiguous",
                                                      "read_only"))
    tdt = torch.int16 if dtype == "int16" else torch.float32
    fb = lc * 2 * (2 if dtype == "int16" else 4)
    batches = feed.plan_batches(total, bf, 0, False, True)
    counted = feed.stage_info()
    card = feed.CardFeed(bf + 2, lc, tdt, torch.device("cpu"))
    chunks = 0
    for b in batches:
        a, k = b.read
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = card.stage(b, [x[a:a + k] for x in chans])
        card.consumed()
        for x, g in zip(chans, got):
            pairs = np.ascontiguousarray(x).view(np.float32).reshape(
                -1, lc, 2) if dtype == "complex64" else x
            want = np.zeros((bf + 2, lc, 2), pairs.dtype)
            want[b.first_slot:b.first_slot + b.hi - b.lo] = pairs[b.lo:b.hi]
            np.testing.assert_array_equal(g.numpy(), want)
        chunks += 2 * -(-k * fb // chunk_bytes)
    card.close()
    sent = 2 * sum(b.read[1] for b in batches)
    assert sent == 2 * (total + 1)
    delta = _feed_delta(counted)
    assert delta["frames_sent"] == sent
    assert delta["frames_reused"] == 2 * 2 * (len(batches) - 1)
    assert delta["bytes_sent"] == sent * fb
    assert delta["chunks"] == chunks
    assert delta["slot_waits"] == 0


def test_chunk_stager_refuses_a_source_of_the_wrong_size(monkeypatch):
    """A source with other than the batch's frames is refused with a clear
    error."""
    from passiveradar_torch import feed
    monkeypatch.setattr(feed, "CHUNK_BYTES", 7)
    lc, bf = 5, 3
    x = _frames_of("int16", 4, lc, 0)
    card = feed.CardFeed(bf + 2, lc, torch.int16, torch.device("cpu"))
    b = feed.plan_batches(3, bf, 0, False, True)[0]
    with pytest.raises(ValueError, match="expected 4 frames"):
        card.stage(b, (x[:3], x[:3]))
    card.close()


def test_chunk_stager_refuses_unequal_lengths_before_copying(monkeypatch):
    """A job whose source and target differ in length is refused before
    any job's bytes are copied or counted."""
    from passiveradar_torch import feed
    monkeypatch.setattr(feed, "CHUNK_BYTES", 3)
    stager = feed.ChunkStager(torch.device("cpu"))
    src = torch.arange(10, dtype=torch.uint8)
    good, bad = torch.zeros(10, dtype=torch.uint8), torch.zeros(
        9, dtype=torch.uint8)
    with pytest.raises(ValueError, match="10 source bytes for 9"):
        stager.send([(src, good), (src, bad)])
    assert not good.any() and not stager.counts
    stager.send([(src, good)])
    assert torch.equal(good, src)
    assert stager.counts == {"chunks": 4, "bytes_sent": 10}
