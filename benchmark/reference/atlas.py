"""The chart atlas, its adjacencies and the camera, worked out from the
published description: a cube-sphere of 96 independent 4x4 vision charts
(1536 vertices, radius 0.25), 5x5 touch charts (25 vertices) for each
finger and grasp slot, dense row-normalised adjacencies with self loops,
and a pinhole camera at (-0.3, 0, 0.3) looking at the origin.

Coincident vision boundary vertices (bit-identical in float32) form a
clique and talk to every touch chart's centre vertex, which is how the
touch charts join the vision graph.
"""

from __future__ import annotations

import numpy as np

TOUCH_CENTER = 12  # row-major centre of the 5x5 touch-chart grid
CAMERA_POSITION = (-0.3, 0.0, 0.3)
CAMERA_FOCAL = 221.7025
IMAGE_SIZE = 256


def grid_faces(n: int, flip: bool = False) -> np.ndarray:
    """2 (n-1)^2 triangles of a row-major (n x n) vertex grid."""
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1
            faces += [[a, c, b], [b, c, d]] if flip else [[a, b, c], [b, d, c]]
    return np.array(faces, np.int64)


def touch_sheet(extent: float = 0.009, n: int = 5) -> tuple[np.ndarray, np.ndarray]:
    lin = np.linspace(-extent, extent, n, dtype=np.float64)
    xx, yy = np.meshgrid(lin, lin, indexing="ij")
    verts = np.stack([xx, yy, np.zeros_like(xx)], axis=-1).reshape(-1, 3)
    return verts.astype(np.float32), grid_faces(n)


def _cube(face: int, u: float, v: float) -> list:
    return [[1.0, u, v], [-1.0, u, v], [u, 1.0, v], [u, -1.0, v], [u, v, 1.0], [u, v, -1.0]][face]


def vision_sphere(radius: float = 0.25, patches: int = 4, grid: int = 4):
    """(1536, 3) float32 vertices and (1728, 3) faces of the atlas."""
    verts, faces, offset = [], [], 0
    n_sub = patches * (grid - 1)
    for face in range(6):
        for pi in range(patches):
            for pj in range(patches):
                for gi in range(grid):
                    for gj in range(grid):
                        u = 2.0 * (pi * (grid - 1) + gi) / n_sub - 1.0
                        v = 2.0 * (pj * (grid - 1) + gj) / n_sub - 1.0
                        p = np.array(_cube(face, u, v))
                        verts.append(p / np.linalg.norm(p) * radius)
                faces.append(grid_faces(grid, flip=face in (1, 2, 5)) + offset)
                offset += grid * grid
    verts = np.round(np.array(verts, np.float64), 6).astype(np.float32)
    return verts, np.concatenate(faces, axis=0)


def adjacency(faces: np.ndarray, n: int) -> np.ndarray:
    adj = np.eye(n, dtype=np.float32)
    for a, b in ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1)):
        adj[faces[:, a], faces[:, b]] = 1
    return adj


def row_normalise(adj: np.ndarray) -> np.ndarray:
    rows = adj.sum(axis=1, keepdims=True)
    return (adj * np.where(rows > 0, 1.0 / np.maximum(rows, 1e-30), 0.0)).astype(np.float32)


def geometry(num_charts: int) -> dict:
    """Everything the deformation model's graph needs, as numpy arrays:
    ``atlas`` (1536, 3), ``original`` (1536, 1536) the normalised vision
    adjacency, ``adj`` (V, V) the normalised fused one, ``faces`` (F, 3)
    the fused faces, with V = 1536 + 25 ``num_charts``."""
    verts, faces = vision_sphere()
    sheet, sheet_faces = touch_sheet()
    nv, nc = len(verts), len(sheet)
    dim = nv + num_charts * nc
    fused = np.zeros((dim, dim), np.float32)
    fused[:nv, :nv] = adjacency(faces, nv)
    all_faces, centres = [faces], []
    for i in range(num_charts):
        s = nv + i * nc
        fused[s:s + nc, s:s + nc] = adjacency(sheet_faces, nc)
        all_faces.append(sheet_faces + s)
        centres.append(s + TOUCH_CENTER)
    groups: dict = {}
    for e, v in enumerate(verts):
        groups.setdefault(v.tobytes(), []).append(e)
    for group in groups.values():
        if len(group) > 1:
            g = np.array(group)
            fused[np.ix_(g, g)] = 1
            fused[np.ix_(g, centres)] = 1
            fused[np.ix_(centres, g)] = 1
    return {
        "atlas": verts,
        "original": row_normalise(adjacency(faces, nv)),
        "adj": row_normalise(fused),
        "faces": np.concatenate(all_faces, axis=0),
    }


def camera_matrix() -> np.ndarray:
    """3x4 K [R | t] of the canonical camera (rows of R: right, down,
    forward), float32."""
    pos = np.asarray(CAMERA_POSITION, np.float64)
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(forward, right), forward])
    k = np.array([[CAMERA_FOCAL, 0, IMAGE_SIZE / 2.0], [0, CAMERA_FOCAL, IMAGE_SIZE / 2.0], [0, 0, 1]])
    return (k @ np.concatenate([rot, (-rot @ pos)[:, None]], axis=1)).astype(np.float32)
