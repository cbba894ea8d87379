"""Small host-side rotation helpers (numpy; scipy only for Rotation).

The port's copy of the JAX package's ``core/rotations.py``.

Used by the simulator for hand placement and finger frames. Covers the
rotation utilities of the reference (``utility/utils.py:289-335``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    return v if n == 0 else v / n


def triangle_normal(a, b, c) -> np.ndarray:
    """Unit normal of the triangle (a, b, c)."""
    n = np.cross(np.asarray(b) - np.asarray(a), np.asarray(c) - np.asarray(a))
    return normalize(n)


def quat_between(vec1, vec2) -> np.ndarray:
    """Quaternion (xyzw) rotating vec1 onto vec2 (Rodrigues construction)."""
    a, b = normalize(vec1), normalize(vec2)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    if s == 0:
        s = 1.0
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    rot = np.eye(3) + kmat + kmat.dot(kmat) * ((1 - c) / (s**2))
    return R.from_matrix(rot).as_quat()


def combine_quats(q1, q2) -> np.ndarray:
    """Compose two quaternions (xyzw) as matrices: R(q1) @ R(q2)."""
    m = R.from_quat(q1).as_matrix() @ R.from_quat(q2).as_matrix()
    return R.from_matrix(m).as_quat()


def euler_to_matrix(angles, translation=(0, 0, 0), order="xyz", degrees=False):
    """4x4 homogeneous transform from euler angles + translation."""
    pose = np.eye(4)
    pose[:3, :3] = R.from_euler(order, angles, degrees=degrees).as_matrix()
    pose[:3, 3] = translation
    return pose


def quat_to_matrix(q) -> np.ndarray:
    return R.from_quat(q).as_matrix()
