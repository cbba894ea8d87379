"""Voxel / orthographic-depth-map operations (re-exported).

The port's copy of the JAX package's ``ops/voxel.py``.

The mesh→voxel subdivision, 6-view ODM extraction, space carving and
surface extraction used by dataset generation live in
:mod:`data.generation` and :mod:`sim.collision` (host-side, vectorized
numpy — they run once per object offline).  Re-exported here so the op
inventory mirrors the reference's geometry core
(``utility/utils.py:382-532``).
"""

from active_3d_vision_and_touch_tpu_torch.data.generation import (  # noqa: F401
    carve_voxels,
    extract_surface_points,
)
from active_3d_vision_and_touch_tpu_torch.sim.collision import (  # noqa: F401
    OccupancyGrid,
    solid_occupancy,
    subdivide_to_density,
)
