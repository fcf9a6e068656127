"""The port's frame meshes, halo exchange, sharded and grouped pipelines,
sharded readers, tensor-parallel CAF and sharded wideband path against the
JAX package, on the CPU (shards are CPU devices; the JAX package runs on
the 8 virtual CPU devices of tests/conftest.py).

Tolerances are the JAX tests' own: the halo bit-identical to
overlap_frames (tests/test_pipeline.py:127); the sharded pipeline and
sharded readers within 1e-3 of the peak (tests/test_pipeline.py:106, 298);
dispatch groups equal to the ungrouped run (tests/test_pipeline.py:173),
and within the port's pipeline bound, 1e-4 of the peak, of the JAX
package's maps (tests/test_torch_pipeline.py); the tensor-parallel CAF
within 1e-5 (tests/test_caf.py:140); the sharded wideband path within 1e-4
(tests/test_wideband.py:187).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from passiveradar_tpu import pipeline as jpl  # noqa: E402
from passiveradar_tpu import wideband as jwb  # noqa: E402
from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io.hdf5 import CaptureReader as JReader  # noqa: E402
from passiveradar_tpu.io.writers import MapWriter as JWriter  # noqa: E402
from passiveradar_tpu.ops.caf import fast_xambg as j_fast_xambg  # noqa: E402
from passiveradar_tpu.parallel.halo import \
    overlap_frames as j_overlap_frames  # noqa: E402
from passiveradar_tpu.parallel.mesh import \
    frame_sharding as j_frame_sharding  # noqa: E402
from passiveradar_tpu.parallel.mesh import \
    make_mesh as j_make_mesh  # noqa: E402
from passiveradar_torch import pipeline as tp  # noqa: E402
from passiveradar_torch import wideband as twb  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.hdf5 import CaptureReader  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, synth_capture_arrays, write_synth_capture)
from passiveradar_torch.io.writers import MapWriter  # noqa: E402
from passiveradar_torch.ops.caf import fast_xambg, fast_xambg_tp  # noqa: E402
from passiveradar_torch.parallel import (  # noqa: E402
    local_overlap, make_mesh, overlap_frames, overlap_frames_shmap)
from tests.test_torch_pipeline import TINY  # noqa: E402
from tests.test_wideband import WB, _cnoise, _wb_signals  # noqa: E402


def cpu_mesh(n, axis_name="frames"):
    return make_mesh(devices=["cpu"] * n, axis_name=axis_name)


def _peak_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _argmax_equal(got, want):
    for f in range(want.shape[0]):
        assert (np.unravel_index(np.argmax(np.abs(got[f])), got[f].shape)
                == np.unravel_index(np.argmax(np.abs(want[f])),
                                    want[f].shape)), f


def _frames(cfg, n):
    ref, srv = synth_capture_arrays(
        cfg, n, targets=(Target(30, -15.0, 0.1),), seed=0)
    ln = cfg.input_chunk_length
    return (ref[:n * ln].reshape(n, ln), srv[:n * ln].reshape(n, ln),
            tp.frame_phases(cfg, list(range(n))))


def _xambg(path):
    with h5py.File(path, "r") as f:
        return np.asarray(f["/xambg"])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_halo_blocks_bit_identical_to_overlap_frames(n):
    """Per-shard halo blocks, concatenated, equal overlap_frames (the
    port's and the JAX package's) bit for bit, with zero capture edges and
    one exchange a direction a call."""
    rng = np.random.default_rng(n)
    x = _cnoise(rng, 6 * 32).reshape(6, 32)
    want = np.asarray(j_overlap_frames(jnp.asarray(x), 8))
    xt = torch.from_numpy(x)
    assert np.array_equal(overlap_frames(xt, 8).numpy(), want)
    before = local_overlap.exchanges
    blocks = local_overlap(list(torch.chunk(xt, n)), 8)
    assert local_overlap.exchanges - before == 2
    assert [tuple(b.shape) for b in blocks] == [(6 // n, 48)] * n
    got = torch.cat(blocks).numpy()
    assert np.array_equal(got, want)
    assert np.all(got[0, :8] == 0) and np.all(got[-1, -8:] == 0)
    assert np.array_equal(overlap_frames_shmap(xt, 8, cpu_mesh(n)).numpy(),
                          want)


def test_process_frames_shmap_matches_jax():
    """8 TINY frames over 2 CPU shards against the JAX package's shard_map
    pipeline on a 2-device mesh (1e-3 of the peak, argmax equal) and the
    port's process_frames; 4 halo exchanges a call, one a direction a
    channel, as the JAX program's 4 ppermutes."""
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    ref, srv, ph = _frames(cfg_t, 8)
    jmesh = j_make_mesh(2)
    sh = j_frame_sharding(jmesh)
    want = np.asarray(jpl.process_frames_shmap(
        jax.device_put(jnp.asarray(ref), sh),
        jax.device_put(jnp.asarray(srv), sh),
        jax.device_put(jnp.asarray(ph), sh), cfg_j, jmesh))
    before = local_overlap.exchanges
    blocks = tp.process_frames_shmap(ref, srv, ph, cfg_t, cpu_mesh(2))
    assert local_overlap.exchanges - before == 4
    assert [tuple(b.shape)[0] for b in blocks] == [4, 4]
    got = torch.cat(blocks).numpy()
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert _peak_rel(got, want) < 1e-3
    _argmax_equal(got, want)
    single = tp.process_frames(ref, srv, ph, cfg_t, device="cpu").numpy()
    assert _peak_rel(got, single) < 1e-4


def test_process_frames_groups_matches_jax_and_loop():
    """(G, F) = (2, 4) batches: the JAX package's scan within the port's
    pipeline bound, and exactly the port's process_frames per batch."""
    cfg_j, cfg_t = j_derive(TINY), t_derive(TINY)
    ref, srv, _ = _frames(cfg_t, 8)
    refs, srvs = ref.reshape(2, 4, -1), srv.reshape(2, 4, -1)
    phs = np.stack([tp.frame_phases(cfg_t, list(range(4))),
                    tp.frame_phases(cfg_t, list(range(4, 8)))])
    want = np.asarray(jpl.process_frames_groups(
        jnp.asarray(refs), jnp.asarray(srvs), jnp.asarray(phs), cfg_j))
    got = tp.process_frames_groups(refs, srvs, phs, cfg_t,
                                   device="cpu").numpy()
    assert got.shape == want.shape == (2, 4, cfg_t.num_doppler_cells,
                                       cfg_t.num_range_cells + 1)
    for g in range(2):
        assert _peak_rel(got[g], want[g]) < 1e-4
        _argmax_equal(got[g], want[g])
        loop = tp.process_frames(refs[g], srvs[g], phs[g], cfg_t,
                                 device="cpu").numpy()
        assert np.array_equal(got[g], loop)


@pytest.fixture(scope="module")
def capture7(tmp_path_factory):
    """A TINY capture of exactly 7 frames (odd: shards of 3 + 4; the
    writer adds one frame to the count it is given) and the single-reader
    port run over it in batches of 3."""
    d = tmp_path_factory.mktemp("par")
    params = dict(TINY, num_frames=7, input_file=str(d / "cap.hdf5"))
    cfg = t_derive(params)
    write_synth_capture(params["input_file"], cfg, 6,
                        targets=(Target(40, 20.0, 0.1),))
    reader = CaptureReader(cfg, estimate_offset=False, device="cpu")
    assert reader.num_frames == 7
    w = MapWriter(cfg, 7, str(d / "one.hdf5"))
    assert tp.run_capture(reader, w, cfg, batch_frames=3, progress=False,
                          device="cpu") == 7
    w.close()
    reader.close()
    return d, params, cfg, _xambg(str(d / "one.hdf5"))


def test_run_capture_dispatch_groups_matches_ungrouped_and_jax(capture7):
    """dispatch_groups = 3 over 4 batches of 2 (the JAX package's groups of
    3 + 1, the last padded with zero batches; the port runs one batch a
    call whatever G is): equal to the ungrouped run, within 1e-4 of the JAX
    package's grouped run, and fewer than 1 group is refused."""
    d, params, cfg, _ = capture7
    reader = CaptureReader(cfg, estimate_offset=False, device="cpu")
    for tag, g in (("ung", 1), ("grp", 3)):
        w = MapWriter(cfg, 7, str(d / f"{tag}.hdf5"))
        assert tp.run_capture(reader, w, cfg, batch_frames=2, progress=False,
                              device="cpu", dispatch_groups=g) == 7
        w.close()
    with pytest.raises(ValueError, match="dispatch_groups"):
        tp.run_capture(reader, None, cfg, batch_frames=2, progress=False,
                       device="cpu", dispatch_groups=0)
    reader.close()
    got, ung = _xambg(str(d / "grp.hdf5")), _xambg(str(d / "ung.hdf5"))
    assert np.array_equal(got, ung)
    cfg_j = j_derive(params)
    jr = JReader(cfg_j, params["input_file"], estimate_offset=False)
    jw = JWriter(cfg_j, 7, str(d / "grp_j.hdf5"))
    jpl.run_capture(jr, jw, cfg_j, batch_frames=2, progress=False,
                    dispatch_groups=3)
    jw.close()
    jr.close()
    want = _xambg(str(d / "grp_j.hdf5"))
    assert _peak_rel(got, want) < 1e-4
    _argmax_equal(np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0))


def test_sharded_readers_match_single_reader(capture7, monkeypatch):
    """Two reader shards, run one after the other as two processes would,
    reproduce the single-reader stack (1e-3 of the peak): 3 + 4 frames, the
    remainder on the last; part 1 reads one margin frame before its range,
    and its mixing phases come from the global frame index."""
    d, params, cfg, want = capture7
    seen = []
    impl = tp._process_frames_impl

    def spy(raw_ref, raw_srv, phases, cfg_):
        seen.append(phases.clone())
        return impl(raw_ref, raw_srv, phases, cfg_)

    monkeypatch.setattr(tp, "_process_frames_impl", spy)
    parts = []
    for p in range(2):
        r = CaptureReader(cfg, estimate_offset=False,
                          device="cpu").shard(p, 2)
        assert (r.num_frames, r.frame_offset) == ((3, 0), (4, 3))[p]
        assert (r.frame_margin_before, r.frame_margin_after) == \
            ((False, True), (True, False))[p]
        w = MapWriter(cfg, r.num_frames, str(d / f"part{p}.hdf5"))
        seen.clear()
        tp.run_capture(r, w, cfg, batch_frames=3, progress=False,
                       device="cpu")
        w.close()
        r.close()
        parts.append(_xambg(str(d / f"part{p}.hdf5")))
    # part 1's first batch: slots 0..4 hold global frames 2..6
    np.testing.assert_array_equal(
        seen[0][:5].numpy(),
        tp.frame_phases(cfg, [2, 3, 4, 5, 6]).astype(np.float32))
    got = np.concatenate(parts, axis=2)
    assert got.shape == want.shape
    assert _peak_rel(got, want) < 1e-3
    _argmax_equal(np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0))


def test_run_capture_on_a_mesh_matches_single_device(capture7, monkeypatch):
    """run_capture(mesh=) routes every batch through process_frames_shmap
    (batch 3 + 2 margins rounded up to 6 frames over 2 shards) and writes
    the single-device stack."""
    d, _, cfg, want = capture7

    def boom(*a, **k):
        raise AssertionError("single-device path used under a mesh")

    monkeypatch.setattr(tp, "_process_frames_impl", boom)
    reader = CaptureReader(cfg, estimate_offset=False, device="cpu")
    w = MapWriter(cfg, 7, str(d / "mesh.hdf5"))
    before = local_overlap.exchanges
    assert tp.run_capture(reader, w, cfg, batch_frames=3, progress=False,
                          mesh=cpu_mesh(2)) == 7
    w.close()
    reader.close()
    assert local_overlap.exchanges - before == 4 * 3      # 3 batches
    got = _xambg(str(d / "mesh.hdf5"))
    assert _peak_rel(got, want) < 1e-4
    _argmax_equal(np.moveaxis(got, 2, 0), np.moveaxis(want, 2, 0))


@pytest.fixture(scope="module")
def jax_stack7(capture7):
    """The JAX package's run_capture over capture7 in batches of 3."""
    d, params, _, _ = capture7
    cfg_j = j_derive(params)
    jr = JReader(cfg_j, params["input_file"], estimate_offset=False)
    jw = JWriter(cfg_j, 7, str(d / "feed_j.hdf5"))
    jpl.run_capture(jr, jw, cfg_j, batch_frames=3, progress=False)
    jw.close()
    jr.close()
    return _xambg(str(d / "feed_j.hdf5"))


@pytest.mark.parametrize("shards", [None, 2])
def test_run_capture_stages_through_the_feed(capture7, jax_stack7, shards):
    """run_capture on one CPU device and on cpu_mesh(2) assembles every
    batch through feed.CardFeed on host tensors: three batches of 3, each
    frame read from the capture once (by the reader's ``fill_frames`` into
    the prefetch reader's pool, or by ``read_pair_frames``), two halo slots
    a channel reused at each batch after the first; the maps agree with the JAX package's
    run_capture at the pipeline bound (1e-4 of the peak, argmax equal)."""
    from passiveradar_torch import feed
    d, _, cfg, _ = capture7
    reader = CaptureReader(cfg, estimate_offset=False, device="cpu")
    read, plain, plain_fill = [], reader.read_pair_frames, reader.fill_frames

    def counted(start, count):
        read.extend(range(start, start + count))
        return plain(start, count)

    def counted_fill(start, count, out):
        read.extend(range(start, start + count))
        plain_fill(start, count, out)

    reader.read_pair_frames = counted
    reader.fill_frames = counted_fill
    w = MapWriter(cfg, 7, str(d / f"feed_{shards}.hdf5"))
    before = feed.stage_info()
    kw = dict(device="cpu") if shards is None else dict(
        mesh=cpu_mesh(shards))
    assert tp.run_capture(reader, w, cfg, batch_frames=3, progress=False,
                          **kw) == 7
    w.close()
    reader.close()
    delta = {k: v - before[k] for k, v in feed.stage_info().items()}
    assert sorted(read) == list(range(7))
    assert (delta["calls"], delta["batches"]) == (1, 3)
    assert delta["frames_sent"] == 2 * 7
    assert delta["frames_reused"] == 2 * 2 * (3 - 1)
    got = _xambg(str(d / f"feed_{shards}.hdf5"))
    assert _peak_rel(got, jax_stack7) < 1e-4
    _argmax_equal(np.moveaxis(got, 2, 0), np.moveaxis(jax_stack7, 2, 0))


@pytest.mark.parametrize("n", [2, 4])
def test_fast_xambg_tp_matches_single_device(n):
    """The tensor-parallel CAF on n CPU shards: lag blocks that concatenate
    to fast_xambg (the port's and the JAX package's) within 1e-5."""
    rng = np.random.default_rng(n)
    length, nf, r = 8192, 128, 15
    ref, srv = _cnoise(rng, length), _cnoise(rng, length)
    want = np.asarray(j_fast_xambg(ref, srv, r, nf, window=("kaiser", 5.0)))
    blocks = fast_xambg_tp(ref, srv, r, nf, cpu_mesh(n, "tp"),
                           window=("kaiser", 5.0))
    assert [tuple(b.shape) for b in blocks] == [(nf, (r + 1) // n)] * n
    got = torch.cat(blocks, dim=1).numpy()
    assert _peak_rel(got, want) < 1e-5
    single = fast_xambg(torch.from_numpy(ref), torch.from_numpy(srv), r, nf,
                        window=("kaiser", 5.0)).numpy()
    assert _peak_rel(got, single) < 1e-5


def test_wideband_frames_shmap_matches_jax(tmp_path):
    """Channels (1, 2) over 2 CPU shards, directly and through
    run_wideband_capture(mesh=): within 1e-4 of the JAX package's
    wideband_frames, argmax equal."""
    params = dict(WB, input_file=str(tmp_path / "wb.hdf5"),
                  output_fname=str(tmp_path / "WB"))
    cfg_j, cfg_t = j_derive(params), t_derive(params)
    ref, srv = _wb_signals(cfg_j, 3, np.random.default_rng(12345))
    n = cfg_j.cpi_samples * cfg_j.wideband_channels
    r3, s3 = ref.reshape(3, n), srv.reshape(3, n)
    want = np.asarray(jwb.wideband_frames(r3, s3, cfg_j))
    mesh = cpu_mesh(2, "channels")
    blocks = twb.wideband_frames_shmap(r3, s3, cfg_t, mesh)
    assert [tuple(b.shape) for b in blocks] == [(3, 1, 64, 9)] * 2
    got = torch.cat(blocks, dim=1).numpy()
    assert _peak_rel(got, want) < 1e-4
    for f in range(3):
        _argmax_equal(got[f], want[f])

    with h5py.File(params["input_file"], "w") as f:
        f.create_dataset("/data/ref", data=ref.view(np.float32))
        f.create_dataset("/data/srv", data=srv.view(np.float32))
    reader = CaptureReader(cfg_t, estimate_offset=False, device="cpu")
    assert twb.run_wideband_capture(reader, cfg_t, progress=False,
                                    mesh=mesh) == 3
    reader.close()
    for i, ch in enumerate((1, 2)):
        stack = np.moveaxis(_xambg(twb.channel_path(cfg_t, ch)), 2, 0)
        assert _peak_rel(stack, want[:, i]) < 1e-4


def test_meshes_that_do_not_divide_raise():
    """Every sharded path raises ValueError where its axis does not divide
    the mesh; a mesh is never built short of the devices asked for."""
    cfg = t_derive(TINY)
    raw = np.zeros((5, cfg.input_chunk_length), np.float32)
    with pytest.raises(ValueError, match="divide"):
        tp.process_frames_shmap(raw, raw, np.zeros(5, np.float32), cfg,
                                cpu_mesh(2))
    x = np.zeros(8192, np.complex64)
    with pytest.raises(ValueError, match="divide"):
        fast_xambg_tp(x, x, 15, 128, cpu_mesh(3))       # 128 % 3
    with pytest.raises(ValueError, match="divide"):
        fast_xambg_tp(x, x, 14, 128, cpu_mesh(2))       # 15 % 2
    wcfg = t_derive(dict(WB, input_file=""))
    w = np.zeros((1, wcfg.cpi_samples * wcfg.wideband_channels),
                 np.complex64)
    with pytest.raises(ValueError, match="selected"):
        twb.wideband_frames_shmap(w, w, wcfg, cpu_mesh(3))
    with pytest.raises(ValueError, match="per-channel samples"):
        twb.wideband_frames_shmap(
            w, w, t_derive(dict(WB, input_file="",
                                wideband_channel_select=(0, 1, 2))),
            cpu_mesh(3))
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"])
