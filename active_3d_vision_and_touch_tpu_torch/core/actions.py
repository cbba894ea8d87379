"""The action sphere: evenly distributed hand-approach directions.

The port's copy of the JAX package's ``core/actions.py``.

Each discrete action is a unit direction from which the hand approaches the
object.  Directions are generated with the standard equal-area spiral
placement of N points on S^2 (same deterministic scheme as the reference's
``get_circle``, ``utility/utils.py:257-284``, so action indices are
comparable across frameworks).
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def action_sphere(num_points: int = 50) -> np.ndarray:
    """(num_points, 3) float32 unit vectors, deterministic equal-area layout.

    Raises if the equal-area construction does not land exactly on
    ``num_points`` (it does for the canonical 50).
    """
    points = []
    a = 4 * math.pi / float(num_points)
    d = math.sqrt(a)
    m_theta = round(math.pi / d)
    d_theta = math.pi / m_theta
    d_phi = a / d_theta
    for i in range(m_theta):
        theta = math.pi * (i + 0.5) / m_theta
        m_phi = round(2 * math.pi * math.sin(theta) / d_phi)
        for j in range(m_phi):
            phi = 2 * math.pi * j / m_phi
            points.append(
                [
                    math.sin(theta) * math.cos(phi),
                    math.sin(theta) * math.sin(phi),
                    math.cos(theta),
                ]
            )
    pts = np.array(points, np.float32)
    if pts.shape[0] != num_points:
        raise ValueError(
            f"equal-area sphere layout produced {pts.shape[0]} points, "
            f"wanted {num_points}"
        )
    return pts
