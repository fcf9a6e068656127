"""Target detection and tracking: CFAR maps → measurements → Kalman tracks.

The frame-at-a-time multitarget tracker that streaming runs, and the batch
trackers over a stored stack (multitarget and single-target) that the
track CLIs run."""

from passiveradar_torch.detect.kalman import (
    adaptive_kalman_update,
    default_kalman_state,
    kalman_extrapolate,
    kalman_update,
)
from passiveradar_torch.detect.measurements import get_measurements
from passiveradar_torch.detect.trackers import (
    init_tracks,
    multitarget_step,
    multitarget_tracker,
    simple_target_tracker,
)

__all__ = [
    "kalman_update",
    "adaptive_kalman_update",
    "kalman_extrapolate",
    "default_kalman_state",
    "get_measurements",
    "init_tracks",
    "multitarget_step",
    "multitarget_tracker",
    "simple_target_tracker",
]
