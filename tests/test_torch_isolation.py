"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "passiveradar_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax():
    """A fresh interpreter imports every module of the port, with h5py and
    matplotlib blocked; neither jax nor passiveradar_tpu may end up in
    sys.modules."""
    # the CLIs that draw import matplotlib only to draw; the HDF5 subset
    # stands in for h5py
    assert {"passiveradar_torch.cli.preview",
            "passiveradar_torch.cli.plot",
            "passiveradar_torch.io.hdf5_min"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        "sys.modules['h5py'] = None   # the card's host may lack h5py\n"
        "sys.modules['matplotlib'] = None   # imported when rendering only\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', "
        "'passiveradar_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_names_no_jax():
    """A text scan of the package's Python, CUDA and C++ sources: no
    import of jax, and no mention of the JAX package's module name anywhere
    (code, comments or docstrings)."""
    imp = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.MULTILINE)
    suffixes = {p.suffix for p in PKG.rglob("*")}
    assert {".py", ".cu", ".cc"} <= suffixes
    for path in sorted(PKG.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cc"):
            continue
        text = path.read_text()
        assert "passiveradar_tpu" not in text, path
        assert not imp.search(text), path


def test_hdf5_subset_imports_numpy_and_the_standard_library_only():
    """io/hdf5_min.py, the HDF5 reader and writer for hosts without h5py,
    imports numpy and standard-library modules, nothing else (no h5py)."""
    import ast
    tree = ast.parse((PKG / "io" / "hdf5_min.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "numpy" in names and "h5py" not in names
    assert names - {"numpy"} <= set(sys.stdlib_module_names), names


def test_default_device_raises_without_cuda(tmp_path):
    """Entry points default to the CUDA card and raise when it is absent;
    only device='cpu' reaches the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from passiveradar_torch._device import resolve_device
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.pipeline import process_frames
    from passiveradar_torch.ops.xcorr import find_channel_offset
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    cfg = derive_config(dict(input_sample_rate=49152,
                             input_center_freq=1_000_000,
                             channel_freq=990_170, channel_bandwidth=12800,
                             cpi_seconds_nominal=1.0))
    raw = np.zeros((1, cfg.input_chunk_length), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        process_frames(raw, raw, np.zeros(1, np.float32), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        find_channel_offset(np.ones(64, np.complex64),
                            np.ones(64, np.complex64), 1, 4)

    # the post-processing and wideband entry points
    from passiveradar_torch import wideband as wb
    from passiveradar_torch.cli.plot import LazyCFAR, cfar_stack
    from passiveradar_torch.detect.trackers import (multitarget_tracker,
                                                    simple_target_tracker)
    from passiveradar_torch.ops.channelizer import channelize
    from passiveradar_torch.viz.persistence import persistence
    from passiveradar_torch.viz.render import (iter_display_frames,
                                               prepare_display_frames)
    stack = np.ones((8, 6, 2), np.float32)
    wcfg = derive_config(dict(input_sample_rate=65536, channel_freq=0,
                              input_center_freq=0, channel_bandwidth=65536,
                              cpi_seconds_nominal=0.25,
                              max_doppler_nominal=128.0,
                              max_range_nominal=150.0, wideband_channels=4))
    wide = np.zeros((1, wcfg.input_chunk_length // 2), np.complex64)
    calls = [
        lambda: cfar_stack(stack),
        lambda: LazyCFAR(stack),
        lambda: multitarget_tracker(stack, (1.0, 1.0), frames_last=True),
        lambda: simple_target_tracker(stack, 1.0, 1.0, frames_last=True),
        lambda: persistence(stack, 1, 2, 0.9),
        lambda: next(iter_display_frames(stack)),
        lambda: prepare_display_frames(stack),
        lambda: channelize(np.ones(64, np.complex64), 4),
        lambda: wb.wideband_frames(wide, wide, wcfg),
        lambda: wb.process_wideband_frame(wide[0], wide[0], 4, 8, 64, 6,
                                          65536.0),
        lambda: wb.run_wideband_capture(None, wcfg),
        lambda: wb.WidebandStreamingProcessor(wcfg),
    ]
    # the meshes, the grouped pipeline and the multi-process runtime
    from passiveradar_torch.parallel.distributed import (
        process_device, run_capture_multihost)
    from passiveradar_torch.parallel.mesh import local_mesh, make_mesh
    from passiveradar_torch.pipeline import process_frames_groups
    calls += [
        make_mesh,
        local_mesh,
        lambda: make_mesh(1),
        lambda: process_frames_groups(raw[None], raw[None],
                                      np.zeros((1, 1), np.float32), cfg),
        process_device,
        lambda: run_capture_multihost(cfg),
    ]
    # the last modules: caf_batch, the device generator and the preview
    from passiveradar_torch.cli.preview import preview_arrays, welch_psd
    from passiveradar_torch.io.synthetic import synth_capture_device
    from passiveradar_torch.pipeline import caf_batch
    if_frames = np.zeros((1, cfg.output_chunk_length), np.complex64)
    calls += [
        lambda: caf_batch(if_frames, if_frames, cfg),
        lambda: synth_capture_device(cfg, 1),
        lambda: welch_psd(np.ones(4096, np.complex64)),
        lambda: preview_arrays(cfg, None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    import yaml
    from passiveradar_torch.cli.process import main
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        input_file=str(tmp_path / "missing.hdf5"), input_sample_rate=49152,
        input_center_freq=1_000_000, channel_freq=990_170,
        channel_bandwidth=12800, cpi_seconds_nominal=1.0)))
    for extra in ([], ["--shard"], ["--dispatch-groups", "2"],
                  ["--num-processes", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config", str(cfg_path)] + extra)

    # the post-processing CLIs, and cli.wideband and cli.stream on a
    # wideband configuration
    from passiveradar_torch.cli import plot, preview, stream, track_multi, \
        track_simple, wideband
    wide_path = tmp_path / "w.yaml"
    wide_path.write_text(yaml.safe_dump(dict(
        input_file=str(tmp_path / "missing.hdf5"), input_sample_rate=65536,
        input_center_freq=0, channel_freq=0, channel_bandwidth=65536,
        cpi_seconds_nominal=0.25, wideband_channels=4)))
    for cli, path, extra in ((plot, cfg_path, []), (preview, cfg_path, []),
                             (track_multi, cfg_path, []),
                             (track_simple, cfg_path, []),
                             (wideband, wide_path, []),
                             (wideband, wide_path, ["--shard"]),
                             (stream, wide_path, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--config", str(path)] + extra)


def test_ops_exports_the_jax_ops_api():
    """Every name of the JAX package's ``ops.__all__`` is exported by the
    port's ``ops``, except the Pallas ``nlms_filter_pallas``, whose
    counterpart is ``nlms_filter_batch``."""
    import passiveradar_torch.ops as tops
    import passiveradar_tpu.ops as jops
    want = set(jops.__all__) - {"nlms_filter_pallas"}
    missing = sorted(want - set(tops.__all__))
    assert not missing, missing
    for name in want | {"nlms_filter_batch"}:
        assert callable(getattr(tops, name)), name
