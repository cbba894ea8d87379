"""Mesh primitives: OBJ I/O and the canonical chart geometry.

The port's own numpy copy of the JAX package's ``core/mesh.py``
(``load_obj``, ``save_obj``, ``touch_chart``, ``vision_charts``,
``scale_points``, ``add_reverse_faces``); the vertex and face arrays are
bit-identical, which the parity tests rely on.

- the *touch chart*: a 5x5-vertex square sheet (25 verts / 32 faces);
- the *vision chart atlas*: a cube-sphere of 6 x 4 x 4 independent 4x4
  charts (1536 verts / 1728 faces) whose coincident boundary vertices are
  bit-identical in float32, the contract :mod:`core.adjacency` stitches on.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """A triangle mesh. verts: (V, 3) float32, faces: (F, 3) int32."""

    verts: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "verts", np.asarray(self.verts, np.float32))
        object.__setattr__(self, "faces", np.asarray(self.faces, np.int32))

    @property
    def num_verts(self) -> int:
        return int(self.verts.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])


def load_obj(path: str) -> Mesh:
    """A minimal wavefront OBJ reader: vertex positions (``v`` lines; ``vt``
    and ``vn`` are skipped) and faces, a polygon fan-triangulated, a
    ``v/vt/vn`` token read for its vertex index."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                # OBJ indices are 1-based
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0] - 1, idx[k] - 1, idx[k + 1] - 1])
    return Mesh(np.array(verts, np.float32), np.array(faces, np.int32))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        f.write(f"# {len(verts)} vertices\n")
        for v in np.asarray(verts):
            f.write("v %f %f %f\n" % tuple(float(x) for x in v[:3]))
        if faces is not None and len(faces):
            f.write(f"# {len(faces)} faces\n")
            for face in np.asarray(faces):
                f.write("f %d %d %d\n" % tuple(int(i) + 1 for i in face[:3]))


def _grid_faces(n: int, flip: bool = False) -> np.ndarray:
    """Triangulate an (n x n) vertex grid (row-major) into 2*(n-1)^2 faces."""
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = i * n + j + 1
            c = (i + 1) * n + j
            d = (i + 1) * n + j + 1
            if flip:
                faces.append([a, c, b])
                faces.append([b, c, d])
            else:
                faces.append([a, b, c])
                faces.append([b, d, c])
    return np.array(faces, np.int32)


# row-major center of the 5x5 touch-chart grid, wired into every vision
# boundary vertex when the graphs are fused
TOUCH_CHART_CENTER = 12


@functools.lru_cache(maxsize=None)
def touch_chart(extent: float = 0.009, n: int = 5) -> Mesh:
    """The canonical touch chart: a flat (n x n) sheet in the sensor's image
    plane, centered on the origin of the sensor frame."""
    lin = np.linspace(-extent, extent, n, dtype=np.float64)
    xx, yy = np.meshgrid(lin, lin, indexing="ij")
    verts = np.stack([xx, yy, np.zeros_like(xx)], axis=-1).reshape(-1, 3)
    return Mesh(verts.astype(np.float32), _grid_faces(n))


def _cube_point(face: int, u: float, v: float) -> np.ndarray:
    """Map (face, u, v) with u,v in [-1, 1] onto the unit cube surface."""
    if face == 0:
        return np.array([+1.0, u, v])
    if face == 1:
        return np.array([-1.0, u, v])
    if face == 2:
        return np.array([u, +1.0, v])
    if face == 3:
        return np.array([u, -1.0, v])
    if face == 4:
        return np.array([u, v, +1.0])
    return np.array([u, v, -1.0])


@functools.lru_cache(maxsize=None)
def vision_charts(
    radius: float = 0.25, patches_per_side: int = 4, grid: int = 4
) -> Mesh:
    """The canonical vision chart atlas: a cube-sphere of independent charts.

    6 cube faces x (patches_per_side^2) patches, each a (grid x grid) vertex
    sheet projected onto a sphere of ``radius``; charts are disconnected in
    the face graph and share bit-identical boundary vertex positions.
    """
    verts = []
    faces = []
    offset = 0
    n_sub = patches_per_side * (grid - 1)  # global grid resolution per face
    for face in range(6):
        for pi in range(patches_per_side):
            for pj in range(patches_per_side):
                for gi in range(grid):
                    for gj in range(grid):
                        u = 2.0 * (pi * (grid - 1) + gi) / n_sub - 1.0
                        v = 2.0 * (pj * (grid - 1) + gj) / n_sub - 1.0
                        p = _cube_point(face, u, v)
                        p = p / np.linalg.norm(p) * radius
                        verts.append(p)
                flip = face in (1, 2, 5)
                faces.append(_grid_faces(grid, flip=flip) + offset)
                offset += grid * grid
    verts = np.array(verts, np.float64)
    # snap to a fixed decimal grid so coincident boundary vertices produced
    # by different cube-face parameterizations are bit-identical in float32
    verts = np.round(verts, 6).astype(np.float32)
    return Mesh(verts, np.concatenate(faces, axis=0))


def scale_points(points: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Center a point set and normalize its largest extent to 1/scale, as
    the reference preprocesses its objects (``utility/utils.py:347-356``):
    shift to the positive octant, divide by the global max and by
    ``scale``, center each axis."""
    points = np.array(points, np.float32)
    points -= points.min(axis=0, keepdims=True)
    points = points / points.max()
    points = points / scale
    points -= (points.max(axis=0, keepdims=True)) / 2.0
    return points


def add_reverse_faces(faces: np.ndarray) -> np.ndarray:
    """Append reversed windings so that a one-sided rasterizer sees both
    sides (reference ``utility/utils.py:337-345``)."""
    f = np.asarray(faces)
    return np.concatenate([f, f[:, [0, 2, 1]], f[:, [2, 1, 0]]], axis=0)
