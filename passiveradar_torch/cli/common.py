"""Shared CLI plumbing."""

from __future__ import annotations

import argparse
import functools

import yaml

from passiveradar_torch.config import RadarConfig, load_config


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, type=str,
                   help="Path to the YAML configuration file")
    return p


def load(args) -> RadarConfig:
    try:
        return load_config(args.config)
    except FileNotFoundError:
        raise SystemExit(f"error: configuration file not found: {args.config}")
    except yaml.YAMLError as e:
        raise SystemExit(f"error: malformed configuration {args.config}: {e}")


def fail_on_missing_capture(fn):
    """Wrap a CLI main so a missing capture file exits with a one-line
    error instead of an h5py traceback."""
    @functools.wraps(fn)
    def wrapped(argv=None):
        try:
            return fn(argv)
        except FileNotFoundError as e:
            raise SystemExit(f"error: {e}")
    return wrapped


def banner(cfg: RadarConfig, device) -> None:
    print("-" * 67)
    print(f"   PASSIVE RADAR (PyTorch, {device}) ")
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
