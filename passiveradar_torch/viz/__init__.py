"""Visualization: digital-phosphor persistence and frame/video rendering."""

from passiveradar_torch.viz.persistence import persistence, persistence_stack

__all__ = ["persistence", "persistence_stack"]
