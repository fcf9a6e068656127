"""The benchmark's file deployment
(``benchmark/configs/fm_upstream_file.json``, cell ``fm_file``) on the CPU
at the small FM geometry: the capture the traffic writes and
``io/hdf5.CaptureReader``'s offset search, the maps of ``run_capture``
over the aligned file against those over a ring of the same int16 frames,
a small copy of the cell through the harness, planted faults that read
not correct, the ``align_ms.file`` reader, the prefetch reader's
counters and ``close()``, and its batches read straight into pooled
buffers against the reader's fresh arrays."""

import importlib.util
import io
import os
import re
import tempfile
import time
import types

import numpy as np
import pytest
import torch

from benchmark.core import cells, harness, scene, spans, trace
from benchmark.reference import geometry
from benchmark.tests import tiny
from benchmark.traffic import file_capture, ring_capture
from passiveradar_torch import derive_config, pipeline
from passiveradar_torch.io import hdf5 as port_hdf5
from passiveradar_torch.io import hdf5_min
from passiveradar_torch.io import writers as port_writers
from passiveradar_torch.ops.xcorr import find_channel_offset

CELL = "fm_file"
TINY = "tiny_fm_file"
CHECKS = ["map_err", "offset_err", "frames_missing"]
SMALL_MAP_ERR = 1e-3


def _params():
    return dict(tiny._load(f"{tiny.BENCH}/configs/fm_upstream_file.json"),
                **tiny.FM)


def _mix():
    mix = dict(tiny._load(f"{tiny.BENCH}/traffic/fm_file_calls.json"),
               **tiny.CELLS["tiny_fm_ring"][2], skew_samples=[100, 5000])
    for t in mix["scene"]["targets"]:
        t["delay_samples"] = max(1, t["delay_samples"] // 50)
    return mix


@pytest.fixture(scope="module")
def rings():
    """A 6-frame ring of the cell's scene as int16 IQ pairs."""
    g = geometry.derive(_params())
    ref, srv = scene.make_ring(g, _mix()["scene"], 6, 7, "cpu")
    return tuple(scene.to_int16_pairs(x, g["int16_scale"])
                 for x in (ref, srv))


def _backend(name):
    if name == "h5py":
        return pytest.importorskip("h5py")
    return hdf5_min


def _tiled(ring, frames):
    return np.concatenate([ring] * -(-frames // ring.shape[0]))[:frames]


# ---- (a) the written capture and the offset search --------------------------

@pytest.mark.parametrize("backend", ["hdf5_min", "h5py"])
@pytest.mark.parametrize("k", [1, -1, 37, -37, 4999, -4999])
def test_capture_reader_finds_the_planted_skew(tmp_path, monkeypatch, rings,
                                               backend, k):
    """The traffic's capture of 2 aligned frames with skew ``k``, through
    either backend: the reader's offset is k, it serves both frames, and
    they are the ring's int16 values bit for bit."""
    mod = _backend(backend)
    monkeypatch.setattr(port_hdf5, "hdf5_backend", lambda: mod)
    p = _params()
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, p, *rings, 2, k, mod)
    reader = port_hdf5.CaptureReader(
        derive_config(dict(p, input_file=path, num_frames=1)), device="cpu")
    try:
        assert reader.offset == k and reader.num_frames == 2
        got = reader.read_pair_frames(0, 2)
    finally:
        reader.close()
    for x, ring in zip(got, rings):
        np.testing.assert_array_equal(x, _tiled(ring, 2))


@pytest.mark.parametrize("k", [2345, -2345])
def test_two_pass_offset_search_finds_the_planted_skew(tmp_path, rings, k):
    """The search past its largest FFT (the cell's head at 5,000,000 lags):
    the coarse FIR pass then the exact pass still find k."""
    p = _params()
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, p, *rings, 2, k, hdf5_min)
    with hdf5_min.File(path, "r") as f:
        ref, srv = (f[p[key]][:].astype(np.float32).view(np.complex64)
                    for key in ("input_ref_path", "input_srv_path"))
    n = min(ref.size, srv.size)
    assert find_channel_offset(ref[:n], srv[:n], 1, n - 1, max_fft=1 << 15,
                               device="cpu") == k


def test_skew_is_drawn_from_the_seed_within_the_mix():
    cell = cells.find(CELL)
    ks = [file_capture.skew(cell, s) for s in range(2**33, 2**33 + 40)]
    assert ks == [file_capture.skew(cell, s)
                  for s in range(2**33, 2**33 + 40)]
    assert all(1000 <= abs(k) <= 100_000 for k in ks)
    assert min(ks) < 0 < max(ks)


# ---- (b) the file path against the ring path --------------------------------

def test_file_maps_bit_equal_the_ring_maps(tmp_path, rings):
    """``run_capture`` over the aligned file (13 frames, a skew) and over a
    RingReader of the same int16 frames give the same 12 maps bit for bit:
    the 13th frame is the last map's right halo in both."""
    p = _params()
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, p, *rings, 13, -1234)
    cfg = derive_config(dict(p, input_file=path, num_frames=12))
    reader = port_hdf5.CaptureReader(cfg, device="cpu")
    from_file = ring_capture.Sink(range(12))
    try:
        assert reader.offset == -1234
        pipeline.run_capture(reader, from_file, cfg, progress=False,
                             device="cpu")
    finally:
        reader.close()
    margin = cfg.frame_batch + 2
    ref, srv = (np.concatenate([x, x[:margin]]) for x in rings)
    from_ring = ring_capture.Sink(range(12))
    pipeline.run_capture(ring_capture.RingReader(ref, srv, 6, 0, 13),
                         from_ring, cfg, progress=False, device="cpu")
    assert sorted(from_file.kept) == list(range(12))
    for i in range(12):
        np.testing.assert_array_equal(from_file.kept[i], from_ring.kept[i])


def test_stack_written_and_read_back_through_hdf5_min_reads_the_same_in_h5py(
        tmp_path, monkeypatch, rings):
    """The cell's call and read-back with io/hdf5_min in h5py's place (as on
    a machine without h5py): h5py, an independent reader, finds in the
    written stack the ring path's 12 maps bit for bit and ``frames_done``
    12, and the frames the traffic read back are h5py's."""
    h5py = pytest.importorskip("h5py")
    _without_h5py(monkeypatch)
    assert port_writers.hdf5_backend() is hdf5_min
    p = _params()
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, p, *rings, 13, 321)
    cfg = derive_config(dict(p, input_file=path, num_frames=12,
                             output_fname=str(tmp_path / "XAMBG"),
                             range_doppler_map_ftype="hdf5"))
    state = types.SimpleNamespace(cfg=cfg, device="cpu", keep=[0, 5, 11])
    assert file_capture._call(state) == (321, 12)
    kept, done = file_capture._read_back(state)
    with h5py.File(cfg.range_doppler_map_fname, "r") as f:
        stack = f["/xambg"][...]
        assert int(f["/xambg"].attrs["frames_done"]) == done == 12
    for pos, frame in kept.items():
        np.testing.assert_array_equal(frame, stack[:, :, pos])
    margin = cfg.frame_batch + 2
    ref, srv = (np.concatenate([x, x[:margin]]) for x in rings)
    from_ring = ring_capture.Sink(range(12))
    pipeline.run_capture(ring_capture.RingReader(ref, srv, 6, 0, 13),
                         from_ring, cfg, progress=False, device="cpu")
    for i in range(12):
        np.testing.assert_array_equal(stack[:, :, i], from_ring.kept[i])


# ---- (c), (d) a small copy of the cell through the harness ------------------

def make_copy(dst: str) -> str:
    """``tiny.make_copy`` with a small copy of fm_file added as new files
    and entries: fm_upstream_file at tiny.FM's geometry, the mix with
    tiny_fm_ring's short ring and skews of 100-5,000 samples, and a
    ``map_err`` limit for the small size: 1e-3, between the program's
    2.2e-5 and the TF32 control's 3.7e-3-5.8e-3 there (the cell's 0.015
    sits between its readings at the published widths, where the sums
    are longer)."""
    bench = tiny.make_copy(dst)
    spec = cells.load_json(os.path.join(dst, "BENCHMARK.json"))
    real = next(w for w in spec["workloads"] if w["name"] == CELL)
    config = next(c for c in spec["configs"] if c["name"] == real["config"])
    tiny._dump(_params(), os.path.join(bench, "configs", TINY + ".json"))
    tiny._dump(_mix(), os.path.join(bench, "traffic", TINY + ".json"))
    check = tiny._load(f"{tiny.BENCH}/workloads/{CELL}.json")
    check["limits"]["map_err"] = SMALL_MAP_ERR
    tiny._dump(check, os.path.join(bench, "workloads", TINY + ".json"))
    spec["configs"].append(dict(config, name=TINY,
                                file=f"benchmark/configs/{TINY}.json"))
    spec["workloads"].append(dict(real, name=TINY, config=TINY,
                                  traffic=TINY))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    tiny._dump(spec, os.path.join(dst, "BENCHMARK.json"))
    return bench


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("bench")))


def _files_gone(notes: str) -> bool:
    """The directory the run named for its files is gone, and lay outside
    the checkout."""
    found = re.search(r"written with \S+ in (\S+) \(", notes)
    assert found, notes
    where = found.group(1)
    return not os.path.exists(where) and not where.startswith(tiny.REPO)


def _without_h5py(monkeypatch):
    """importlib sees no h5py: the port writes and reads through
    io/hdf5_min, as on a machine without it."""
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py"
                        else find(name, *a))


@pytest.mark.parametrize("traced", [False, True])
def test_small_cell_runs_correct(copy, monkeypatch, traced):
    _without_h5py(monkeypatch)
    log = io.StringIO()
    r = harness.run(TINY, 2**33 + 9, 0.3, traced, device="cpu", root=copy,
                    log=log)
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == CHECKS
    assert r["checks"]["offset_err"]["value"] == 0
    assert r["checks"]["frames_missing"]["value"] == 0
    assert r["attempted"] > 0 and r["failed"] == 0
    notes = log.getvalue()
    assert "written with hdf5_min" in notes
    assert "stack read back with hdf5_min" in notes
    assert "prefetch reads:" in notes
    assert _files_gone(notes)
    cell = cells.find(TINY, copy)
    if traced:
        assert r["metrics"]["align_ms.file"]["value"] > 0
        assert r["metrics"]["graph_captures.capture"]["value"] == 0
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert "align_ms.file" in {m["name"] for m in cell.per_layer}


def _drop_second_batch(monkeypatch):
    write = port_writers.MapWriter.write

    def dropped(self, frames, start):
        if start != self.cfg.frame_batch:
            write(self, frames, start)
    monkeypatch.setattr(port_writers.MapWriter, "write", dropped)


@pytest.mark.parametrize("fault", ["offset_off_by_one", "write_dropped"])
def test_planted_fault_is_not_correct(copy, monkeypatch, fault):
    if fault == "offset_off_by_one":
        find = port_hdf5.find_channel_offset
        monkeypatch.setattr(port_hdf5, "find_channel_offset",
                            lambda *a, **k: find(*a, **k) + 1)
        want = "offset_err"
    else:
        _drop_second_batch(monkeypatch)
        want = "frames_missing"
    log = io.StringIO()
    r = harness.run(TINY, 11, 0.2, False, device="cpu", root=copy, log=log)
    assert r["correct"] is False
    assert r["checks"][want]["value"] > r["checks"][want]["limit"]
    assert _files_gone(log.getvalue())


@pytest.mark.parametrize("where", ["warm_up", "window"])
def test_a_failed_run_removes_its_files(copy, monkeypatch, where):
    """run_capture raising in the warm-up or in the window's first call:
    the run raises, and its directory is gone at once."""
    made = []
    mkdtemp = tempfile.mkdtemp
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: made.append(
        mkdtemp(*a, **k)) or made[-1])
    run = pipeline.run_capture
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == (1 if where == "warm_up" else 2):
            raise OSError("read error")
        return run(*a, **k)
    monkeypatch.setattr(pipeline, "run_capture", failing)
    with pytest.raises(OSError, match="read error"):
        harness.run(TINY, 13, 0.2, False, device="cpu", root=copy,
                    log=io.StringIO())
    assert len(made) == 1 and not os.path.exists(made[0])


def test_control_is_not_correct_and_float64_is(copy):
    """The cell's control, judged by its check at the small size: TF32
    operands read not correct, the float64 reference against itself reads
    0 everywhere."""
    from benchmark import control
    from benchmark.reference.precision import FP64, TF32
    cell = cells.find(TINY, copy)
    tf32 = control.judged(cell, 5, torch.device("cpu"), TF32)
    assert tf32["correct"] is False
    assert tf32["checks"]["map_err"]["value"] > 3 * SMALL_MAP_ERR
    same = control.judged(cell, 5, torch.device("cpu"), FP64)
    assert same["correct"] is True
    assert all(v["value"] == 0.0 for v in same["checks"].values())


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size():
    """The TF32 control at the cell's published widths on the card, one
    call and two positions, judged by the cell's own check: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reference at 2.4 MS/s")
    from benchmark import control
    from benchmark.reference.precision import TF32
    cell = cells.find(CELL)
    cell.check.update(control_captures=1)
    cell.mix.update(keep_positions=[0], seeded_positions=1)
    r = control.judged(cell, 7, torch.device("cuda"), TF32)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["map_err"]["value"] > 0.015


# ---- (e) the align_ms.file reader -------------------------------------------

def _ctx(spans_):
    cell = cells.find(CELL)
    return harness.Context([], spans_, 1.0, 0, cell,
                           geometry.derive(cell.config))


def test_align_reader_reads_nothing_from_an_empty_trace():
    ctx = _ctx([])
    assert cells.find(CELL).reader("align_ms.file").read(ctx) is None
    assert ctx.notes and "align_ms.file" in ctx.notes[0]


def test_align_reader_reads_the_median_span():
    found = [trace.Span("capture.align", 10**9 * i, 10**9 * i + ms * 10**6)
             for i, ms in enumerate([120.0, 80.0, 95.5])]
    found.append(trace.Span("capture.batch", 0, 5 * 10**9))
    ctx = _ctx(found)
    assert cells.find(CELL).reader("align_ms.file").read(ctx) == \
        pytest.approx(95.5)
    assert len(spans.named(found, "capture.align")) == 3


# ---- (f) the prefetch reader's counters and close() -------------------------

class _Frames:
    """A reader whose frames are (count, 5, 2) int16 a channel."""

    num_frames = 40
    pair_dtype = np.int16

    def read_pair_frames(self, start, count):
        x = np.full((count, 5, 2), start, np.int16)
        return x, x.copy()


def test_read_info_counts_what_the_prefetch_reader_read():
    batches = [(0, 2), (2, 3), (5, 1)]
    before = port_hdf5.read_info()
    got = list(port_hdf5.PrefetchReader(_Frames(), batches))
    after = port_hdf5.read_info()
    delta = {k: after[k] - before[k] for k in after}
    assert [(s, c) for s, c, _ in got] == batches
    assert delta["batches"] == 3
    assert delta["bytes"] == 2 * 6 * 5 * 2 * 2
    assert delta["read_s"] >= 0 and delta["put_wait_s"] >= 0


def test_close_ends_a_thread_blocked_on_a_full_queue():
    pf = port_hdf5.PrefetchReader(_Frames(), [(i, 1) for i in range(40)])
    first = next(iter(pf))
    assert first[0] == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert pf._q.empty()


def test_run_capture_closes_the_prefetch_reader_when_a_write_fails(
        monkeypatch, rings):
    """A writer that raises at the second batch: run_capture raises, and the
    prefetch thread has ended (it no longer holds its batches and file)."""
    made = []

    class Recorded(port_hdf5.PrefetchReader):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(pipeline, "PrefetchReader", Recorded)

    class Failing(ring_capture.Sink):
        def write(self, frames, start):
            if start > 0:
                raise OSError("disk full")
            super().write(frames, start)

    cfg = derive_config(dict(_params(), num_frames=12, frame_batch=2))
    ref, srv = (np.concatenate([x, x[:4]]) for x in rings)
    with pytest.raises(OSError, match="disk full"):
        pipeline.run_capture(ring_capture.RingReader(ref, srv, 6, 0, 12),
                             Failing(()), cfg, progress=False, device="cpu")
    assert len(made) == 1
    made[0]._thread.join(timeout=5)
    assert not made[0]._thread.is_alive()


# ---- (g) the prefetch reader's pooled buffers over an HDF5 capture ----------

def _capture_reader(monkeypatch, tmp_path, rings, frames, k, backend,
                    dtype="int16", **params):
    """A CaptureReader through ``backend`` over the traffic's capture of
    ``frames`` aligned frames with skew ``k``; as float32 values (the int16
    values times the scale) for ``dtype`` "float32"."""
    mod = _backend(backend)
    monkeypatch.setattr(port_hdf5, "hdf5_backend", lambda: mod)
    p = dict(_params(), **params)
    path = str(tmp_path / "cap.h5")
    file_capture.write_capture(path, p, *rings, frames, k, hdf5_min)
    if dtype == "float32":
        with hdf5_min.File(path, "r") as f:
            values = {key: f[p[key]][:].astype(np.float32) * p["int16_scale"]
                      for key in ("input_ref_path", "input_srv_path")}
        with hdf5_min.File(path, "w") as f:
            for key, x in values.items():
                f.create_dataset(p[key], data=x)
    return port_hdf5.CaptureReader(derive_config(dict(p, input_file=path)),
                                   device="cpu")


def _info_delta(before):
    after = port_hdf5.read_info()
    return {k: after[k] - before[k] for k in after}


class _Done:
    frames_done = 0


@pytest.mark.parametrize("backend", ["hdf5_min", "h5py"])
@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("k", [1234, -1234])
@pytest.mark.parametrize("dtype,mode", [("int16", "pair"),
                                        ("float32", "pair"),
                                        ("float32", "iq"), ("int16", "iq")])
def test_prefetch_batches_bit_equal_the_readers_fresh_arrays(
        tmp_path, monkeypatch, rings, backend, shard, k, dtype, mode):
    """Every batch of ``capture_batches``' plan (the first of bf + 1
    frames, a short last one; a sharded reader's margins on both sides)
    through the prefetch reader equals ``read_pair_frames`` /
    ``read_iq_frames``' fresh arrays bit for bit, in their dtype. Where the
    values delivered are the values stored, every batch is read straight
    into the pool (``direct``), of at most four pairs; int16 read as
    complex64 is converted on the host and keeps the reader's arrays."""
    reader = _capture_reader(monkeypatch, tmp_path, rings, 13, k, backend,
                             dtype, num_frames=11, frame_batch=3)
    try:
        assert reader.offset == k
        if shard:
            reader.shard(1, 3)
            assert reader.frame_margin_before and reader.frame_margin_after
        total, batches = pipeline.capture_batches(reader, _Done(),
                                                  reader.cfg, 3)
        reads = [b.read for b in batches]
        if not shard:
            assert reads[0] == (0, 4) and reads[-1][1] < 3
        fill = reader.fill_layout(mode) is not None
        assert fill == (dtype == "float32" or mode == "pair")
        before = port_hdf5.read_info()
        pf = port_hdf5.PrefetchReader(reader, reads, mode=mode)
        read = getattr(reader, f"read_{mode}_frames")
        n = 0
        for (start, count, got), want in zip(pf, reads):
            assert (start, count) == want
            for a, b in zip(got, read(start, count)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            n += 1
        pf.close()
    finally:
        reader.close()
    d = _info_delta(before)
    assert n == d["batches"] == len(reads)
    assert d["direct"] == (len(reads) if fill else 0)
    if fill:
        assert 1 <= d["buffers"] <= min(4, len(reads))
    else:
        assert d["buffers"] == 0


def test_prefetch_pool_reads_20_batches_into_at_most_four_pairs(
        tmp_path, monkeypatch, rings):
    """20 batches through a consumer slower than the reader (the queue
    full, the thread waiting): ``direct`` reads 20 and ``buffers`` at most
    4, and each batch still holds its frames until the next is asked for."""
    reader = _capture_reader(monkeypatch, tmp_path, rings, 21, -77,
                             "hdf5_min", num_frames=20, frame_batch=1)
    try:
        _, batches = pipeline.capture_batches(reader, _Done(), reader.cfg, 1)
        reads = [b.read for b in batches]
        assert len(reads) == 20
        before = port_hdf5.read_info()
        pf = port_hdf5.PrefetchReader(reader, reads)
        for start, count, got in pf:
            time.sleep(0.02)            # the thread runs ahead meanwhile
            for a, b in zip(got, reader.read_pair_frames(start, count)):
                np.testing.assert_array_equal(a, b)
        pf.close()
    finally:
        reader.close()
    d = _info_delta(before)
    assert d["batches"] == d["direct"] == 20
    assert 1 <= d["buffers"] <= 4


@pytest.mark.parametrize("store", ["zarr", "interleaved"])
def test_prefetch_keeps_the_readers_arrays_where_it_cannot_fill(
        tmp_path, store):
    """A zarr store and the 4-way interleaved layout: ``fill_layout`` is
    None in both modes, and the prefetch reader yields the reader's own
    arrays, equal to a fresh read, with nothing pooled."""
    from passiveradar_torch.io.synthetic import write_synth_capture
    path = str(tmp_path / ("cap.zarr" if store == "zarr" else "cap.h5"))
    cfg = derive_config(dict(_params(), input_file=path, frame_batch=2,
                             interleaved_input_channels=store != "zarr"))
    write_synth_capture(path, cfg, 5, dtype=np.int16)
    reader = port_hdf5.CaptureReader(cfg, device="cpu")
    try:
        assert reader.fill_layout("pair") is None
        assert reader.fill_layout("iq") is None
        before = port_hdf5.read_info()
        for start, count, got in port_hdf5.PrefetchReader(
                reader, [(0, 3), (3, 2)]):
            for a, b in zip(got, reader.read_pair_frames(start, count)):
                np.testing.assert_array_equal(a, b)
    finally:
        reader.close()
    d = _info_delta(before)
    assert d["batches"] == 2 and d["direct"] == d["buffers"] == 0


def test_prefetch_yields_a_plain_readers_own_arrays():
    """A reader with only ``read_pair_frames`` (a ring, a live SDR): each
    batch is the very arrays it returned, and nothing is pooled."""
    returned = []

    class Recorded(_Frames):
        def read_pair_frames(self, start, count):
            returned.append(super().read_pair_frames(start, count))
            return returned[-1]

    before = port_hdf5.read_info()
    got = [arrays for _, _, arrays in port_hdf5.PrefetchReader(
        Recorded(), [(0, 2), (2, 3), (5, 1)])]
    d = _info_delta(before)
    assert len(got) == len(returned) == 3
    assert all(a is b for g, r in zip(got, returned) for a, b in zip(g, r))
    assert d["batches"] == 3 and d["direct"] == d["buffers"] == 0


def test_file_maps_through_hdf5_min_direct_reads_bit_equal_the_ring_maps(
        tmp_path, monkeypatch, rings):
    """``run_capture`` over the aligned file read by io/hdf5_min straight
    into the pool (every batch ``direct``) writes the same 12 maps bit for
    bit as over a RingReader of the same int16 frames."""
    reader = _capture_reader(monkeypatch, tmp_path, rings, 13, 4321,
                             "hdf5_min", num_frames=12)
    assert isinstance(reader._file, hdf5_min.File)
    cfg = reader.cfg
    from_file = ring_capture.Sink(range(12))
    before = port_hdf5.read_info()
    try:
        pipeline.run_capture(reader, from_file, cfg, progress=False,
                             device="cpu")
    finally:
        reader.close()
    d = _info_delta(before)
    assert d["direct"] == d["batches"] == -(-12 // cfg.frame_batch)
    assert 1 <= d["buffers"] <= 4
    margin = cfg.frame_batch + 2
    ref, srv = (np.concatenate([x, x[:margin]]) for x in rings)
    from_ring = ring_capture.Sink(range(12))
    pipeline.run_capture(ring_capture.RingReader(ref, srv, 6, 0, 13),
                         from_ring, cfg, progress=False, device="cpu")
    assert sorted(from_file.kept) == list(range(12))
    for i in range(12):
        np.testing.assert_array_equal(from_file.kept[i], from_ring.kept[i])
