"""Frame-axis halo exchange (single device in this slice)."""

from passiveradar_torch.parallel.halo import overlap_frames

__all__ = ["overlap_frames"]
