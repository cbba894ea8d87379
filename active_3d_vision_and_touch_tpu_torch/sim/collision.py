"""Voxel occupancy for contact queries (the simulator's "physics").

The port's copy of the JAX package's ``sim/collision.py``.

The reference delegates contact handling to Bullet's collision engine; here
contact is resolved against a solid voxel occupancy of the object:
triangles are recursively subdivided until smaller than a cell (same
strategy as the reference's ``mesh_to_voxel``, ``utility/utils.py:382-450``,
but vectorized numpy over the whole triangle soup), the surface cells are
marked, and the interior is filled.  Point-in-object queries are then O(1)
lookups — plenty for finger-curl contact detection at 3–6 mm resolution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage


def subdivide_to_density(
    verts: np.ndarray, faces: np.ndarray, max_edge: float
) -> np.ndarray:
    """Point soup covering the surface with inter-point spacing < max_edge."""
    v1 = verts[faces[:, 0]].astype(np.float64)
    v2 = verts[faces[:, 1]]
    v3 = verts[faces[:, 2]]
    points = [v1, v2, v3]
    limit = max_edge**2
    while len(v1):
        sides = np.stack(
            [
                ((v1 - v2) ** 2).sum(1),
                ((v2 - v3) ** 2).sum(1),
                ((v3 - v1) ** 2).sum(1),
            ],
            axis=1,
        ).max(1)
        keep = sides > limit
        if not keep.any():
            break
        v1, v2, v3 = v1[keep], v2[keep], v3[keep]
        m12, m23, m31 = (v1 + v2) / 2, (v2 + v3) / 2, (v3 + v1) / 2
        points += [m12, m23, m31]
        v1 = np.concatenate([v1, m12, m12, m31])
        v2 = np.concatenate([m12, v2, m23, m23])
        v3 = np.concatenate([m31, m23, m31, v3])
    return np.concatenate(points, axis=0)


@dataclass
class OccupancyGrid:
    occ: np.ndarray  # (R, R, R) bool
    origin: np.ndarray  # (3,) world position of voxel (0,0,0) corner
    cell: float

    def contains(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) world points → (N,) bool inside the solid object."""
        idx = np.floor((np.asarray(points) - self.origin) / self.cell).astype(int)
        r = self.occ.shape[0]
        in_bounds = np.all((idx >= 0) & (idx < r), axis=-1)
        idx = np.clip(idx, 0, r - 1)
        hit = self.occ[idx[..., 0], idx[..., 1], idx[..., 2]]
        return hit & in_bounds


def solid_occupancy(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution: int = 96,
    margin: float = 0.02,
) -> OccupancyGrid:
    """Solid voxel occupancy of a (centered) object mesh."""
    verts = np.asarray(verts, np.float64)
    lo = verts.min(0) - margin
    hi = verts.max(0) + margin
    cell = float((hi - lo).max()) / resolution
    origin = lo
    pts = subdivide_to_density(verts, np.asarray(faces), cell)
    idx = np.clip(((pts - origin) / cell).astype(int), 0, resolution - 1)
    occ = np.zeros((resolution,) * 3, bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    occ = ndimage.binary_fill_holes(occ)
    return OccupancyGrid(occ=occ, origin=origin, cell=cell)
