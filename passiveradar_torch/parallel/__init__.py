"""Frame meshes and the CPI-overlap halo exchange between their shards
(multi-process execution: parallel/distributed.py). The JAX package's
``frame_sharding`` has no counterpart: a FrameMesh names its devices, and
the pipeline splits the frame axis over them itself."""

from passiveradar_torch.parallel.halo import (local_overlap, overlap_frames,
                                              overlap_frames_shmap)
from passiveradar_torch.parallel.mesh import FrameMesh, local_mesh, make_mesh

__all__ = [
    "FrameMesh",
    "make_mesh",
    "local_mesh",
    "overlap_frames",
    "overlap_frames_shmap",
    "local_overlap",
]
