"""The port's multi-process runtime, cli.concat and cli.process --profile,
on the CPU.

Two real processes of ``passiveradar_torch.cli.process --device cpu`` join
one gloo process group on a free local port, each processes its
contiguous reader shard of a 7-frame TINY capture (3 + 4 frames, the
remainder on the last) and writes a .partN stack; process 0 writes the
global metadata. ``cli.concat`` merges the parts, which must match the
single-process port run within 1e-3 of the peak (tests/test_multihost.py's
bound: the process-boundary halos come from one-frame disk margins) and
the JAX CLI's stack within the golden pipeline bound, 2e-3 of the peak
with the argmax cell equal in every frame (tests/test_golden_e2e.py).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from passiveradar_torch.cli.concat import find_parts  # noqa: E402
from passiveradar_torch.cli.concat import main as concat_main  # noqa: E402
from passiveradar_torch.cli.process import main as t_main  # noqa: E402
from passiveradar_torch.config import derive_config as t_derive  # noqa: E402
from passiveradar_torch.io.synthetic import (  # noqa: E402
    Target, write_synth_capture)
from passiveradar_torch.parallel.distributed import (  # noqa: E402
    init_distributed, run_capture_multihost)
from tests.test_torch_pipeline import TINY  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PROC_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _xambg(path):
    with h5py.File(path, "r") as f:
        return np.asarray(f["/xambg"]), int(f["/xambg"].attrs["frames_done"])


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_torch")
    params = dict(TINY, num_frames=7, input_file=str(d / "cap.hdf5"),
                  output_fname=str(d / "MH"))
    cfg = t_derive(params)
    write_synth_capture(params["input_file"], cfg, 7,
                        targets=(Target(40, 20.0, 0.1),))
    cfg_path = d / "mh.yaml"
    cfg_path.write_text(yaml.safe_dump(params))
    return d, params, cfg, str(cfg_path)


def _single(d, params, tag):
    """The capture through one process of the port's CLI, to <tag>.hdf5."""
    path = d / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(dict(params, output_fname=str(d / tag))))
    assert t_main(["--config", str(path), "--device", "cpu"]) == 7
    return _xambg(str(d / f"{tag}.hdf5"))[0]


def test_single_process_multihost_path(capture):
    """run_capture_multihost without a process group is the plain run."""
    d, _, cfg, _ = capture
    one = dataclasses.replace(
        cfg, output_fname=str(d / "SOLO"),
        range_doppler_map_fname=str(d / "SOLO.hdf5"),
        meta_fname=str(d / "SOLO.npz"))
    assert run_capture_multihost(one, progress=False, device="cpu") == (7, 7)
    assert os.path.exists(str(d / "SOLO.hdf5"))
    assert np.load(str(d / "SOLO.npz"))["frame_timestamps"].shape == (7,)


def test_two_process_run_and_concat_match_single_process(capture):
    d, params, cfg, cfg_path = capture
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "passiveradar_torch.cli.process",
         "--config", cfg_path, "--device", "cpu", "--num-processes", "2",
         "--process-id", str(p), "--coordinator", coordinator],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "3 frames" in outs[0] and "7 frames globally" in outs[0], outs[0]
    assert "4 frames" in outs[1], outs[1]
    # part stacks of 3 + 4 frames (the remainder on the last process)
    assert _xambg(str(d / "MH.part0.hdf5"))[0].shape[2] == 3
    assert _xambg(str(d / "MH.part1.hdf5"))[0].shape[2] == 4
    assert np.load(str(d / "MH.npz"))["frame_timestamps"].shape == (7,)

    assert concat_main(["--config", cfg_path]) == 7
    assert not os.path.exists(str(d / "MH.part0.hdf5"))
    assert not os.path.exists(str(d / "MH.part1.hdf5"))
    merged, done = _xambg(str(d / "MH.hdf5"))
    assert done == 7 and merged.shape[2] == 7

    want = _single(d, params, "ONE")
    assert np.max(np.abs(merged - want)) < 1e-3 * np.max(np.abs(want))

    from passiveradar_tpu.cli.process import main as j_main
    jpath = d / "jax.yaml"
    jpath.write_text(yaml.safe_dump(dict(params, output_fname=str(d / "J"))))
    j_main(["--config", str(jpath)])
    golden, _ = _xambg(str(d / "J.hdf5"))
    assert np.max(np.abs(merged - golden)) < 2e-3 * np.max(np.abs(golden))
    for f in range(7):
        a, b = np.abs(merged[:, :, f]), np.abs(golden[:, :, f])
        assert np.unravel_index(np.argmax(a), a.shape) == \
            np.unravel_index(np.argmax(b), b.shape), f


def test_concat_zarr_parts_and_keep_parts(capture):
    """Zarr part stores (directories) merge through the port's own zarr
    subset; --keep-parts keeps them; a gap in the part sequence exits."""
    d, params, cfg, _ = capture
    from passiveradar_torch.io.writers import MapWriter
    from passiveradar_torch.io import zarr_min
    zp = dict(params, output_fname=str(d / "ZM"),
              range_doppler_map_ftype="zarr")
    zcfg = t_derive(zp)
    rng = np.random.default_rng(3)
    frames = (rng.standard_normal((5, cfg.num_doppler_cells,
                                   cfg.num_range_cells + 1))
              + 1j).astype(np.complex64)
    for p, (lo, hi) in enumerate(((0, 2), (2, 5))):
        w = MapWriter(zcfg, hi - lo, f"{zcfg.output_fname}.part{p}.zarr")
        w.write(frames[lo:hi], 0)
        w.close()
    path = d / "zm.yaml"
    path.write_text(yaml.safe_dump(zp))
    assert find_parts(zcfg) == [f"{zcfg.output_fname}.part{p}.zarr"
                                for p in (0, 1)]
    assert concat_main(["--config", str(path), "--keep-parts"]) == 5
    merged = zarr_min.open(zcfg.range_doppler_map_fname, mode="r")
    assert merged.attrs["frames_done"] == 5
    np.testing.assert_array_equal(np.moveaxis(np.asarray(merged), 2, 0),
                                  frames)
    os.rename(f"{zcfg.output_fname}.part1.zarr",
              f"{zcfg.output_fname}.part2.zarr")
    with pytest.raises(SystemExit, match="contiguous"):
        find_parts(zcfg)


def test_init_distributed_rejects_coordinator_without_layout():
    """--coordinator alone must fail loudly, not run single-process."""
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed(coordinator_address="127.0.0.1:1234")
    with pytest.raises(ValueError, match="process_id"):
        init_distributed("127.0.0.1:1234", num_processes=2)


def test_init_distributed_reads_a_launchers_environment():
    """With no arguments, init_distributed joins the group that a
    launcher's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT describe (as
    torchrun sets them), where the JAX package detects a TPU pod."""
    code = ("from passiveradar_torch.parallel import distributed as d\n"
            "d.init_distributed()\n"
            "print('RANK', d.process_index(), d.process_count())\n"
            "import torch.distributed as dist\n"
            "dist.destroy_process_group()\n")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO), RANK=str(r),
                 WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"RANK {r} 2" in out, out


def test_cli_profile_writes_a_trace(capture, tmp_path):
    """cli.process --profile DIR writes a torch.profiler Chrome trace of
    the run into DIR (CPU activity here; on the card CUDA too)."""
    d, params, _, _ = capture
    path = d / "prof.yaml"
    path.write_text(yaml.safe_dump(dict(params, num_frames=2,
                                        output_fname=str(d / "PROF"))))
    trace_dir = tmp_path / "trace"
    assert t_main(["--config", str(path), "--device", "cpu",
                   "--profile", str(trace_dir)]) == 2
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::fft") for e in events)
