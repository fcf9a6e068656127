"""Target detection and tracking: CFAR maps → measurements → Kalman tracks.

The frame-at-a-time multitarget tracker that streaming runs; the batch
trackers and their CLIs are not ported yet (see ROADMAP.md)."""

from passiveradar_torch.detect.kalman import (
    adaptive_kalman_update,
    default_kalman_state,
    kalman_extrapolate,
    kalman_update,
)
from passiveradar_torch.detect.measurements import get_measurements
from passiveradar_torch.detect.trackers import init_tracks, multitarget_step

__all__ = [
    "kalman_update",
    "adaptive_kalman_update",
    "kalman_extrapolate",
    "default_kalman_state",
    "get_measurements",
    "init_tracks",
    "multitarget_step",
]
