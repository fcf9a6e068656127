"""Capture ingest, range-Doppler map persistence, synthetic captures."""

from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.io.synthetic import (
    Target,
    synth_capture_arrays,
    wideband_capture_arrays,
    write_synth_capture,
    write_wideband_capture,
)
from passiveradar_torch.io.writers import (
    AbsMapStack,
    MapWriter,
    load_maps,
    write_metadata,
)

__all__ = [
    "AbsMapStack",
    "CaptureReader",
    "MapWriter",
    "load_maps",
    "write_metadata",
    "Target",
    "synth_capture_arrays",
    "write_synth_capture",
    "wideband_capture_arrays",
    "write_wideband_capture",
]
