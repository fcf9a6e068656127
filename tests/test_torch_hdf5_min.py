"""The port's HDF5 subset (passiveradar_torch/io/hdf5_min.py) against h5py,
on the CPU.

h5py is the oracle: the subset reads what h5py writes by default
(captures, chunked stacks, deflate and shuffle) bit-equal, h5py reads what
the subset writes with equal arrays, dtype, chunks, maxshape and
attributes, each continues the other's partial stack, and what the subset
cannot read raises an error that names the feature. The port's run is
forced onto the subset by blocking h5py (``sys.modules["h5py"] = None``,
as tests/test_torch_isolation.py does). Then the slice: cli.process with
the default HDF5 maps on a capture written by the JAX package, --resume,
cli.concat's merge and cli.track_multi, held to the JAX package and to the
port's own h5py run. TINY geometry of tests/test_torch_pipeline.py.
"""

import contextlib
import os
import struct
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_tpu.config import derive_config as j_derive  # noqa: E402
from passiveradar_tpu.io import writers as jw  # noqa: E402
from passiveradar_tpu.io.synthetic import Target as JTarget  # noqa: E402
from passiveradar_tpu.io.synthetic import \
    write_synth_capture as j_write  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io import hdf5_min, writers  # noqa: E402
from passiveradar_torch.io.hdf5 import CaptureReader  # noqa: E402
from tests.data import make_h5py_fixture as fixture  # noqa: E402
from tests.test_torch_pipeline import TINY, _assert_maps_agree  # noqa: E402

STACK = (16, 9, 6)            # a small (Doppler, range + 1, frames) stack
CHUNK = STACK[:2] + (1,)


@contextlib.contextmanager
def no_h5py():
    """Inside the block the port's HDF5 backend is the subset (h5py needs
    its own module entry, so the oracle runs outside the block)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        assert writers.hdf5_backend() is hdf5_min
        yield


def _frames(seed, n=STACK[2]):
    rng = np.random.default_rng(seed)
    shape = STACK[:2] + (n,)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _stored_eof(path):
    with open(path, "rb") as fh:
        return struct.unpack_from("<Q", fh.read(48), 40)[0]


def _h5py_tree(path):
    """{dataset path: (array, dtype, chunks, maxshape, attrs)} through h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out["/" + name] = (obj[...], obj.dtype, obj.chunks,
                                   obj.maxshape, dict(obj.attrs))
        f.visititems(visit)
    return out


def _assert_subset_reads(path):
    """Every dataset of an h5py-written file, read by the subset, is
    bit-equal to h5py's read with the same dtype, chunks and maxshape."""
    want = _h5py_tree(path)
    with hdf5_min.File(path) as f:
        for key, (arr, dtype, chunks, maxshape, attrs) in want.items():
            d = f[key]
            got = d[...]
            assert got.dtype == dtype and d.chunks == chunks, key
            assert d.maxshape == maxshape and len(d) == arr.shape[0], key
            np.testing.assert_array_equal(got, arr, err_msg=key)
            assert sorted(d.attrs) == sorted(attrs), key
            for k, v in attrs.items():
                np.testing.assert_array_equal(d.attrs[k], v, err_msg=k)
            if arr.ndim == 1 and arr.size > 9:       # a strided window
                np.testing.assert_array_equal(d[3:-2:3], arr[3:-2:3])
    return want


# -- reading h5py's files -----------------------------------------------------

@pytest.mark.parametrize("case", ["float32", "int16", "float32_interleaved",
                                  "int16_interleaved", "gzip_shuffle"])
def test_subset_reads_h5py_captures(tmp_path, case):
    """Captures the JAX package's writer (h5py) makes, in both layouts and
    dtypes, and an h5py chunked dataset under gzip + shuffle: the subset's
    reads are bit-equal, and so are the port's CaptureReader's frames."""
    path = str(tmp_path / "cap.h5")
    params = dict(TINY, input_file=path)
    if case == "gzip_shuffle":
        rng = np.random.default_rng(3)
        with h5py.File(path, "w") as f:
            for key in ("/data/ref", "/data/srv"):
                f.create_dataset(key, data=np.round(
                    rng.standard_normal(50_000) * 300).astype(np.int16),
                    chunks=(4096,), compression="gzip", shuffle=True)
        _assert_subset_reads(path)
        return
    dtype = np.int16 if case.startswith("int16") else np.float32
    interleaved = case.endswith("interleaved")
    params["interleaved_input_channels"] = interleaved
    j_write(path, j_derive(params), 4, interleaved=interleaved, dtype=dtype,
            targets=(JTarget(40, 20.0, 0.12),), channel_offset=3)
    want = _assert_subset_reads(path)
    assert set(want) == ({"/data"} if interleaved
                         else {"/data/ref", "/data/srv"})
    cfg = t_derive(params)
    with no_h5py():
        got = CaptureReader(cfg, device="cpu")
        assert isinstance(got._file, hdf5_min.File)
        frames = got.read_pair_frames(1, 2)
        got.close()
    ref = CaptureReader(cfg, device="cpu")
    assert isinstance(ref._file, h5py.File)
    assert got.offset == ref.offset
    for a, b in zip(frames, ref.read_pair_frames(1, 2)):
        np.testing.assert_array_equal(a, b)
    ref.close()


def test_fixture_reads_the_same_through_h5py_and_the_subset():
    """tests/data/h5py_fixture.h5 (h5py's own file, committed) holds the
    arrays its seed regenerates, read by h5py and by the subset alike."""
    assert os.path.getsize(fixture.PATH) < 64 * 1024
    want = fixture.fixture_arrays()
    got = _assert_subset_reads(fixture.PATH)
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key][1] == arr.dtype, key
        np.testing.assert_array_equal(got[key][0], arr, err_msg=key)
    assert got["/xambg"][4] == {"frames_done": fixture.FRAMES_DONE}
    assert got["/gzip/ref"][2] == (fixture.GZIP_CHUNK,)
    with h5py.File(fixture.PATH) as f:    # frames never written: no chunk
        assert f["/xambg"].id.get_num_chunks() == fixture.FRAMES_DONE


@pytest.mark.parametrize("case", ["libver_latest", "lzf", "big_endian",
                                  "string"])
def test_subset_names_what_it_cannot_read(tmp_path, case):
    """Files that h5py reads and the subset does not raise UnsupportedHDF5
    with the feature's name, never a wrong read."""
    path = str(tmp_path / "x.h5")
    kw = dict(libver="latest") if case == "libver_latest" else {}
    with h5py.File(path, "w", **kw) as f:
        data = np.arange(64, dtype=">f4" if case == "big_endian" else "<f4")
        if case == "lzf":
            f.create_dataset("/x", data=data, chunks=(16,), compression="lzf")
        elif case == "string":
            f.create_dataset("/x", data=np.array([b"abc", b"de"]))
        else:
            f.create_dataset("/x", data=data)
    names = dict(libver_latest="superblock version 3", lzf="filter 32000 "
                 "(lzf)", big_endian="big-endian", string="class 3 (string)")
    with pytest.raises(hdf5_min.UnsupportedHDF5, match="not supported "
                       "without h5py") as e:
        with hdf5_min.File(path) as f:
            f["/x"][...]
    assert names[case] in str(e.value)


# -- read_direct ---------------------------------------------------------------

# (dataset dtype and h5py options, source selection, destination shape, the
# part written when smaller (a pooled buffer's [:n]), destination dtype and
# selection; whether the read goes straight into the destination's memory)
_N = 5000
READS = {
    "int16_head": dict(dtype="i2", src=np.s_[0:1200], dest=(1200,)),
    "int16_tail": dict(dtype="i2", src=np.s_[3800:_N], dest=(1200,)),
    "float32_head": dict(dtype="f4", src=np.s_[0:1200], dest=(1200,)),
    "float32_tail": dict(dtype="f4", src=np.s_[3800:_N], dest=(1200,)),
    "short_last_into_a_larger_buffer": dict(
        dtype="i2", src=np.s_[4300:_N], dest=(2000,), part=700),
    "whole": dict(dtype="f4", src=None, dest=(_N,)),
    "rows": dict(dtype="f4", shape=(_N // 2, 2), src=np.s_[10:400],
                 dest=(390, 2)),
    "dest_sel": dict(dtype="i2", src=np.s_[100:600], dest=(800,),
                     dest_sel=np.s_[150:650]),
    "dest_sel_strided": dict(dtype="i2", src=np.s_[100:600], dest=(1000,),
                             dest_sel=np.s_[::2], straight=False),
    "dest_sel_fancy": dict(dtype="i2", src=np.s_[100:103], dest=(10,),
                           dest_sel=np.s_[[1, 4, 8]], straight=False),
    "strided_source": dict(dtype="i2", src=np.s_[0:1000:2], dest=(500,),
                           straight=False),
    "converted": dict(dtype="i2", src=np.s_[0:1200], dest=(1200,),
                      dest_dtype="f4", straight=False),
    "chunked": dict(dtype="i2", kw=dict(chunks=(512,)), src=np.s_[700:1900],
                    dest=(1200,), straight=False),
    "filtered": dict(dtype="f4", kw=dict(chunks=(512,), compression="gzip",
                                         shuffle=True),
                     src=np.s_[3800:_N], dest=(1200,), straight=False),
    "past_the_end": dict(dtype="i2", src=np.s_[4800:5200], dest=(400,),
                         raises=True),
}


@pytest.mark.parametrize("case", list(READS))
def test_read_direct_matches_h5py(tmp_path, monkeypatch, case):
    """``Dataset.read_direct`` against h5py's on h5py's file: the same
    destination bit for bit (what it does not select left as it was), equal
    to ``ds[source_sel]`` placed at ``dest_sel``; straight into the
    destination's memory where the dataset is contiguous and the part is
    contiguous and of the stored dtype, else through ``__getitem__``; a
    selection past the end raises in both."""
    c = READS[case]
    data = (np.random.default_rng(11).standard_normal(c.get("shape", (_N,)))
            * 3000).astype(c["dtype"])
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("/d", data=data, **c.get("kw", {}))
    args = (c["src"], c.get("dest_sel"))

    def fresh():
        buf = np.full(c["dest"], -7, c.get("dest_dtype", c["dtype"]))
        return buf, buf[:c["part"]] if "part" in c else buf

    def read(ds):
        buf, dest = fresh()
        if c.get("raises"):
            with pytest.raises(TypeError, match="broadcast"):
                ds.read_direct(dest, *args)
        else:
            ds.read_direct(dest, *args)
        return buf

    with h5py.File(path, "r") as f:
        want = read(f["/d"])
    calls = []
    getitem = hdf5_min.Dataset.__getitem__
    monkeypatch.setattr(hdf5_min.Dataset, "__getitem__",
                        lambda ds, key: calls.append(key) or getitem(ds, key))
    with hdf5_min.File(path) as f:
        got = read(f["/d"])
        assert bool(calls) == (not c.get("straight", True)
                               and not c.get("raises")), calls
        placed, dest = fresh()
        if not c.get("raises"):
            dest[... if args[1] is None else args[1]] = f["/d"][
                ... if args[0] is None else args[0]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, placed)


def test_read_direct_raises_past_the_end_of_the_file(tmp_path):
    """A contiguous dataset whose bytes the file no longer holds (cut
    short while open): a direct read into them raises, as ``__getitem__``
    does, and one before the cut still reads."""
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("/d", data=np.arange(_N, dtype=np.int16))
    with hdf5_min.File(path) as f:
        os.truncate(path, os.path.getsize(path) - 1000)
        head = np.empty(100, np.int16)
        f["/d"].read_direct(head, np.s_[:100])
        np.testing.assert_array_equal(head, np.arange(100))
        with pytest.raises(OSError, match="past the end of the file"):
            f["/d"].read_direct(np.empty(1200, np.int16), np.s_[3800:])
        with pytest.raises(OSError, match="past the end of the file"):
            f["/d"][3800:]


def test_read_direct_refuses_a_destination_it_cannot_write(tmp_path):
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("/d", data=np.arange(100, dtype=np.int16))
    with hdf5_min.File(path) as f:
        for dest in (np.empty(200, np.int16)[::2],
                     np.empty((10, 10), np.int16, order="F")):
            with pytest.raises(TypeError, match="C-contiguous"):
                f["/d"].read_direct(dest)
        frozen = np.empty(100, np.int16)
        frozen.flags.writeable = False
        with pytest.raises(TypeError, match="writable"):
            f["/d"].read_direct(frozen)


# -- h5py reading the subset's files ------------------------------------------

@pytest.mark.parametrize("written", [6, 4])
def test_h5py_reads_subset_stacks(tmp_path, written):
    """MapWriter through the subset, all 6 frames or the first 4: h5py
    reads the stack bit-equal with complex64, the chunks, the maxshape and
    a scalar int64 frames_done; the stored end of file is the file's size
    after every write."""
    cfg = t_derive(TINY)
    shape = (cfg.num_doppler_cells, cfg.num_range_cells + 1, 6)
    rng = np.random.default_rng(1)
    want = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want[:, :, written:] = 0
    with no_h5py():
        w = writers.MapWriter(cfg, 6, str(tmp_path / "x.hdf5"))
        assert isinstance(w._h5, hdf5_min.File)
        for s in range(0, written, 2):
            w.write(np.moveaxis(want[:, :, s:s + 2], 2, 0), s)
            assert _stored_eof(w.path) == os.path.getsize(w.path)
        w.close()
    got = _h5py_tree(w.path)["/xambg"]
    np.testing.assert_array_equal(got[0], want)
    assert got[1:] == (np.complex64, shape[:2] + (1,), shape,
                       {"frames_done": written})
    assert isinstance(got[4]["frames_done"], np.int64)
    assert _stored_eof(w.path) == os.path.getsize(w.path)


def _small_stack(f, maxshape=None):
    return f.create_dataset("/xambg", shape=STACK, dtype=np.complex64,
                            chunks=CHUNK, maxshape=maxshape)


@pytest.mark.parametrize("direction", ["subset_continues_h5py",
                                       "h5py_continues_subset"])
def test_resume_across_writers(tmp_path, direction):
    """A stack cut at frames_done = 4, continued in mode "a" by the other
    writer (h5py's partial file lacks the chunks it never wrote): h5py
    reads the whole run's stack bit-equal."""
    want = _frames(2)
    first, second = ((h5py, hdf5_min) if direction.startswith("subset")
                     else (hdf5_min, h5py))
    path = str(tmp_path / "x.h5")
    with first.File(path, "w") as f:
        d = _small_stack(f)
        d.attrs["frames_done"] = 0
        d[:, :, :4] = want[:, :, :4]
        d.attrs["frames_done"] = 4
    with second.File(path, "a") as f:
        d = f["/xambg"]
        assert d.attrs.get("frames_done") == 4
        d[:, :, 4:] = want[:, :, 4:]
        d.attrs["frames_done"] = 6
    assert _stored_eof(path) == os.path.getsize(path)
    got = _h5py_tree(path)["/xambg"]
    np.testing.assert_array_equal(got[0], want)
    assert got[2:] == (CHUNK, STACK, {"frames_done": 6})
    _assert_subset_reads(path)


@pytest.mark.parametrize("frames", [10, 150])
def test_resize_matches_h5py(tmp_path, frames):
    """create(maxshape None) → write → resize along the last axis → write,
    through the subset and through h5py: equal stacks, shapes and
    maxshapes (150 chunks need a two-level chunk B-tree)."""
    want = _frames(4, frames)
    got = {}
    for mod in (hdf5_min, h5py):
        path = str(tmp_path / f"{mod.__name__}.h5")
        with mod.File(path, "w") as f:
            d = _small_stack(f, maxshape=STACK[:2] + (None,))
            d[...] = want[:, :, :STACK[2]]
            d.resize(frames, axis=2)
            d[:, :, STACK[2]:] = want[:, :, STACK[2]:]
            d.attrs["frames_done"] = frames
        got[mod] = _h5py_tree(path)["/xambg"]
        assert _stored_eof(path) == os.path.getsize(path)
    np.testing.assert_array_equal(got[hdf5_min][0], want)
    np.testing.assert_array_equal(got[h5py][0], want)
    assert got[hdf5_min][1:] == got[h5py][1:]
    _assert_subset_reads(str(tmp_path / "h5py.h5"))


def test_concat_parts_matches_jax(tmp_path):
    """Two part stacks (one written by h5py, one by the subset) merged by
    the port's concat_parts through the subset and by the JAX package's
    through h5py: bit-equal, with frames_done, chunks and maxshape."""
    parts = [str(tmp_path / f"X.part{i}.hdf5") for i in range(2)]
    want = _frames(5, 11)
    for i, (mod, s, e) in enumerate(((hdf5_min, 0, 5), (h5py, 5, 11))):
        with mod.File(parts[i], "w") as f:
            d = f.create_dataset("/xambg", data=want[:, :, s:e],
                                 chunks=CHUNK)
            d.attrs["frames_done"] = e - s
    with no_h5py():
        assert writers.concat_parts(parts, str(tmp_path / "T.hdf5")) == 11
    assert jw.concat_parts(parts, str(tmp_path / "J.hdf5")) == 11
    got = _h5py_tree(str(tmp_path / "T.hdf5"))["/xambg"]
    ref = _h5py_tree(str(tmp_path / "J.hdf5"))["/xambg"]
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:] == (np.complex64, CHUNK, STACK[:2] + (None,),
                                  {"frames_done": 11})


def test_subset_groups_and_attributes(tmp_path):
    """Nested groups, links h5py adds to a subset file afterwards, and
    attributes replaced by another type: both readers agree."""
    path = str(tmp_path / "g.h5")
    with hdf5_min.File(path, "w") as f:
        for k in range(12):                 # more links than one node holds
            f.create_dataset(f"/a/b/d{k:02d}", data=np.full(3, k, np.int32))
        d = f["/a/b/d03"]
        d.attrs["v"] = 1
        d.attrs["v"] = np.arange(4, dtype=np.float64)   # replaced
        d.attrs["w"] = np.float32(2.5)
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("/a/b/d03", data=np.zeros(1))
    with h5py.File(path, "a") as f:
        assert sorted(f["/a/b"]) == [f"d{k:02d}" for k in range(12)]
        np.testing.assert_array_equal(f["/a/b/d03"].attrs["v"], np.arange(4))
        assert f["/a/b/d03"].attrs["w"] == np.float32(2.5)
        f.create_dataset("/a/c", data=np.arange(5, dtype=np.uint8))
    with hdf5_min.File(path) as f:
        assert f["/a"].keys() == ["b", "c"]
        np.testing.assert_array_equal(f["/a/c"][...], np.arange(5))
        assert f["/a/b/d11"][-1] == 11
        with pytest.raises(PermissionError):
            f["/a/c"][0] = 1
    _assert_subset_reads(path)


# -- the slice: cli.process, --resume, cli.concat, cli.track_multi ------------

@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """A capture the JAX package wrote (h5py, 3-sample channel offset) and
    the JAX CLI's HDF5 stack of it."""
    from passiveradar_tpu.cli.process import main as j_main
    ws = tmp_path_factory.mktemp("torch_hdf5_min")
    params = dict(TINY, num_frames=6, input_file=str(ws / "cap.hdf5"),
                  output_fname=str(ws / "XAMBG_J"))
    j_write(params["input_file"], j_derive(params), 6,
            targets=(JTarget(40, 20.0, 0.12),), channel_offset=3)
    (ws / "jax.yaml").write_text(yaml.safe_dump(params))
    j_main(["--config", str(ws / "jax.yaml")])
    with h5py.File(str(ws / "XAMBG_J.hdf5")) as f:
        want = f["/xambg"][...]
    return ws, params, want


def _port_config(ws, params, tag):
    p = dict(params, output_fname=str(ws / f"XAMBG_{tag}"))
    path = ws / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(p))
    return str(path), t_derive(p)


def test_cli_process_without_h5py_matches_jax(slice_run):
    """cli.process --device cpu with h5py blocked: the HDF5 stack it writes
    opens in h5py and agrees with the JAX CLI's (bound and argmax of
    test_cli_end_to_end_matches_jax); --resume after a cut at
    frames_done = 4 lands on the same stack bit-equal."""
    from passiveradar_torch.cli.process import main as t_main
    ws, params, want = slice_run
    cfg_path, cfg = _port_config(ws, params, "S")
    with no_h5py():
        assert t_main(["--config", cfg_path, "--device", "cpu"]) == 6
    got = _h5py_tree(cfg.range_doppler_map_fname)["/xambg"]
    assert got[1:] == (np.complex64, want.shape[:2] + (1,), want.shape,
                       {"frames_done": 6})
    _assert_maps_agree(np.moveaxis(got[0], 2, 0), np.moveaxis(want, 2, 0))
    with h5py.File(cfg.range_doppler_map_fname, "a") as f:
        f["/xambg"][:, :, 4:] = 0
        f["/xambg"].attrs["frames_done"] = 4
    with no_h5py():
        assert t_main(["--config", cfg_path, "--device", "cpu",
                       "--resume"]) == 6
    resumed = _h5py_tree(cfg.range_doppler_map_fname)["/xambg"]
    np.testing.assert_array_equal(resumed[0], got[0])
    assert resumed[4] == {"frames_done": 6}


def test_cli_concat_and_track_multi_without_h5py(slice_run):
    """Two cli.process part stacks merged by cli.concat with h5py blocked
    equal one whole run; cli.track_multi's tracks from that stack, read by
    the subset, equal those read by h5py."""
    from passiveradar_torch.cli import concat, track_multi
    from passiveradar_torch.cli.process import main as t_main
    ws, params, _ = slice_run
    cfg_path, cfg = _port_config(ws, params, "C")
    whole_path, whole_cfg = _port_config(ws, params, "W")
    assert t_main(["--config", whole_path, "--device", "cpu"]) == 6
    with no_h5py():
        for pid, (s, n) in enumerate(((0, 2), (2, 4))):   # frames 0-1, 2-5
            w = writers.MapWriter(cfg, n,
                                  f"{cfg.output_fname}.part{pid}.hdf5")
            with hdf5_min.File(whole_cfg.range_doppler_map_fname) as f:
                w.write(np.moveaxis(f["/xambg"][:, :, s:s + n], 2, 0), 0)
            w.close()
        assert concat.main(["--config", cfg_path]) == 6
        got_cfar, got_hist = track_multi.track(cfg, device="cpu")
    assert not os.path.exists(f"{cfg.output_fname}.part0.hdf5")
    merged = _h5py_tree(cfg.range_doppler_map_fname)["/xambg"]
    whole = _h5py_tree(whole_cfg.range_doppler_map_fname)["/xambg"]
    np.testing.assert_array_equal(merged[0], whole[0])
    assert merged[4] == {"frames_done": 6}
    want_cfar, want_hist = track_multi.track(cfg, device="cpu")
    np.testing.assert_array_equal(np.asarray(got_cfar), np.asarray(want_cfar))
    _assert_same_history(got_hist, want_hist)


def _assert_same_history(got, want, where="history"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _assert_same_history(got[key], want[key], f"{where}.{key}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)


def test_cli_process_missing_capture_without_h5py(tmp_path):
    """A missing HDF5 capture read through the subset exits with
    fail_on_missing_capture's one line naming the file, as with h5py."""
    from passiveradar_torch.cli.process import main as t_main
    params = dict(TINY, input_file=str(tmp_path / "missing.h5"),
                  output_fname=str(tmp_path / "X"))
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(yaml.safe_dump(params))
    with no_h5py(), pytest.raises(SystemExit) as exc:
        t_main(["--config", str(cfg_path), "--device", "cpu"])
    msg = str(exc.value)
    assert msg.startswith("error:") and "\n" not in msg
    assert "missing.h5" in msg
