"""Capture ingest, range-Doppler map persistence, synthetic captures."""

from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.io.synthetic import (
    Target,
    synth_capture_arrays,
    write_synth_capture,
)
from passiveradar_torch.io.writers import MapWriter, write_metadata

__all__ = [
    "CaptureReader",
    "MapWriter",
    "write_metadata",
    "Target",
    "synth_capture_arrays",
    "write_synth_capture",
]
