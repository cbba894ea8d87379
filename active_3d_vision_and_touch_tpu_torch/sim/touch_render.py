"""Simulated optical touch signal: fingertip depth map → RGB gel image.

The port's copy of the JAX package's ``sim/touch_render.py``.

The fingertip depth camera's map is turned into the image an illuminated
elastomer gel sensor would capture: depth → gel indentation → surface
normals → Phong diffuse shading under three colored point lights.
Behavioral equivalent of the reference's ``depth_to_touch``
(``simulator/scene/instance.py:207-258``), vectorized over lights.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

LIGHT_POSITIONS = np.array([[-0.5, 0.5, 1.0], [1.3, -0.4, 1.0], [1.3, 1.4, 1.0]])
DIFFUSE = 2.0
SMOOTH_KERNEL = 7


def depth_to_touch(depth: np.ndarray, max_depth: float = 0.025) -> np.ndarray:
    """(H, W) depth (0 = no hit) → (H, W, 3) uint8-range float gel image."""
    depth = np.asarray(depth, np.float64).copy()
    dim = depth.shape[-1]

    # out-of-range and missed rays register as "no indentation"
    depth[(depth == 0) | (depth > max_depth)] = max_depth
    untouched = depth >= max_depth
    indentation = np.where(untouched, 0.0, max_depth - depth)
    gel = indentation * 6.0 / max_depth

    height = gel / 30.0 + 0.4
    kernel = np.ones((SMOOTH_KERNEL, SMOOTH_KERNEL)) / SMOOTH_KERNEL**2
    smoothed = ndimage.convolve(height, kernel, mode="reflect")
    height = np.where(untouched, smoothed, height)

    # surface normals from the height-field gradient
    zy, zx = np.gradient(height)
    normal = np.dstack([-zx, -zy, np.ones_like(height)])
    normal = normal / np.linalg.norm(normal, axis=2, keepdims=True)

    # pixel positions on the unit gel plane
    grid = np.arange(dim) / float(dim)
    pos = np.dstack([np.repeat(grid[:, None], dim, 1), np.repeat(grid[None], dim, 0), height])

    # one diffuse term per light → one color channel per light
    img = np.zeros((dim, dim, 3))
    for c in range(3):
        light_dir = LIGHT_POSITIONS[c] - pos
        light_dir = light_dir / np.linalg.norm(light_dir, axis=2, keepdims=True)
        img[:, :, c] = np.clip(DIFFUSE * (normal * light_dir).sum(-1), 0, 1)
    return np.clip(img * 255.0, 0, 255)
