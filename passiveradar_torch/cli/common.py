"""Shared CLI plumbing."""

from __future__ import annotations

import argparse
import contextlib
import functools

import yaml

from passiveradar_torch.config import RadarConfig, load_config


def parser(description: str, modes=None) -> argparse.ArgumentParser:
    """The CLIs' parser: ``--config``, and ``--mode`` (first of ``modes``
    by default) where the CLI has modes."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, type=str,
                   help="Path to the YAML configuration file")
    if modes:
        p.add_argument("--mode", type=str, choices=list(modes),
                       default=list(modes)[0],
                       help=f"Output mode ({'/'.join(modes)})")
    return p


def add_device(p: argparse.ArgumentParser) -> None:
    """``--device {cuda,cpu}``, default cuda (no fallback to the CPU)."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device to run on (default: cuda; there is no "
                        "fallback to the CPU)")


def add_profile(p: argparse.ArgumentParser) -> None:
    """``--profile DIR``: a torch.profiler trace of the run (``profiled``)."""
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the run "
                        "into DIR")


def profiled(trace_dir: str | None, dev):
    """torch.profiler over the run, CPU and (on the card) CUDA activity,
    its Chrome trace written into ``trace_dir`` (the counterpart of
    jax.profiler.trace); a null context without a directory. The trace
    holds the port's spans (``passiveradar_torch/spans.py``) beside the
    device's kernels and copies."""
    if trace_dir is None:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def shard_mesh(device, axis_name: str = "frames"):
    """The mesh of ``--shard``: every local CUDA card, or the one device
    ``--device`` names when it is not the card (the CPU)."""
    from passiveradar_torch.parallel.mesh import make_mesh
    if device.type == "cuda":
        return make_mesh(axis_name=axis_name)
    return make_mesh(devices=[device], axis_name=axis_name)


def load(args) -> RadarConfig:
    try:
        return load_config(args.config)
    except FileNotFoundError:
        raise SystemExit(f"error: configuration file not found: {args.config}")
    except yaml.YAMLError as e:
        raise SystemExit(f"error: malformed configuration {args.config}: {e}")


def fail_on_missing_capture(fn):
    """Wrap a CLI main so a missing capture file exits with a one-line
    error instead of a traceback (h5py and io/hdf5_min.py both raise
    FileNotFoundError for a missing HDF5 capture)."""
    @functools.wraps(fn)
    def wrapped(argv=None):
        try:
            return fn(argv)
        except FileNotFoundError as e:
            raise SystemExit(f"error: {e}")
    return wrapped


def banner(cfg: RadarConfig, device=None) -> None:
    where = "PyTorch" if device is None else f"PyTorch, {device}"
    print("-" * 67)
    print(f"   PASSIVE RADAR ({where}) ")
    print("-" * 67)
    print(f"Input file: {cfg.input_file}")
    print(f"Channel {cfg.channel_freq / 1e6:.1f} MHz, "
          f"bandwidth {cfg.channel_bandwidth / 1e3:.1f} kHz")
    print(f"Input rate {cfg.input_sample_rate / 1e6:.1f} MHz, "
          f"IF rate {cfg.IF_sample_rate / 1e3:.1f} kHz")
    print(f"Max bistatic range {cfg.max_range_actual:.2f} km "
          f"(cell {cfg.range_cell_width:.2f} km)")
    print(f"Max Doppler {cfg.max_doppler_actual:.2f} Hz "
          f"(cell {cfg.doppler_cell_width:.4f} Hz)")
