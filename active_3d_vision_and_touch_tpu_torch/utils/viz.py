"""Visualization: action-coverage plots, prediction renders, depth images.

Port of the JAX package's ``utils/viz.py``: per-policy action histograms
and equirectangular sphere-coverage maps, and renders of predicted meshes,
sampled points and ground truth, all through the port's
``sim/vision_render.py::SceneRenderer`` and ``core/camera.py``.

The port needs neither PIL nor matplotlib (the card's machine has
neither).  PNGs are written by :func:`write_png`, a small 8-bit RGB
encoder on ``zlib``; the action histogram's bars are drawn in numpy, one
bar per action with the heights ``np.bincount`` gives.  Every other image
is the JAX package's pixel for pixel.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.actions import action_sphere
from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera
from active_3d_vision_and_touch_tpu_torch.core.mesh import Mesh
from active_3d_vision_and_touch_tpu_torch.sim.vision_render import SceneRenderer

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
MESH_COLOUR = np.array([228.0, 217.0, 111.0])
POINT_COLOUR = (60, 90, 200)

# the histogram: one bar of _HIST_BAR pixels per action, the tallest bar
# _HIST_PLOT_H pixels, on a white canvas with a black base line
_HIST_BAR, _HIST_PLOT_H, _HIST_MARGIN = 8, 240, 20
_HIST_COLOUR = (31, 119, 180)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(array: np.ndarray) -> bytes:
    """(H, W, 3) values → an 8-bit RGB PNG (no filter, zlib level 6).
    Values are cast with ``astype(np.uint8)``, as the JAX package's PIL
    route does."""
    img = np.ascontiguousarray(np.asarray(array).astype(np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8 bits, truecolour
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(array))


def visualize_depth(depth: np.ndarray, max_depth: float = 0.025) -> np.ndarray:
    """Depth map → display-friendly uint8 (reference ``utils.py:556-560``)."""
    d = np.asarray(depth).copy()
    d[d > max_depth] = 0
    return (255 * d / max_depth).astype(np.uint8)


def _sphere_pixel(point, num_actions: int):
    """Equirectangular pixel for a unit direction (same longitude shift as
    the reference's plots so maps are comparable, ``utils.py:573-579``)."""
    x, y, z = point
    lon = math.atan2(-x, y)
    lon = (lon + np.pi / 2.0) / (2 * np.pi) + np.pi * (28.670 / 360.0)
    lat = math.acos(max(-1.0, min(1.0, z))) / np.pi
    row = int(lat * num_actions * 12 / (2 * np.pi))
    col = int(lon * num_actions * 24 / (2 * np.pi))
    return row, col


def camera_visible_actions(num_actions: int = 50) -> np.ndarray:
    """Boolean mask of action directions on the camera-facing hemisphere
    (the reference's ``objects/visible.obj`` subset,
    ``utility/utils.py:596-600``)."""
    sphere = action_sphere(num_actions)
    cam = np.asarray(PinholeCamera().position, np.float64)
    cam /= np.linalg.norm(cam)
    return (sphere @ cam) > 0.0


def _histogram_image(actions: np.ndarray, num_actions: int) -> np.ndarray:
    """The bars of ``np.bincount(actions, minlength=num_actions)`` (the
    counts of bins ``np.arange(num_actions + 1)``), the tallest
    ``_HIST_PLOT_H`` pixels, each height rounded to a pixel."""
    counts = np.bincount(actions, minlength=num_actions)[:num_actions]
    heights = np.rint(counts * _HIST_PLOT_H / max(int(counts.max(initial=0)), 1)).astype(int)
    m = _HIST_MARGIN
    img = np.full((_HIST_PLOT_H + 2 * m, num_actions * _HIST_BAR + 2 * m, 3), 255, np.uint8)
    base = m + _HIST_PLOT_H  # the row below the bars
    for a, h in enumerate(heights):
        left = m + a * _HIST_BAR
        img[base - h : base, left + 1 : left + _HIST_BAR - 1] = _HIST_COLOUR
    img[base, m : m + num_actions * _HIST_BAR] = 0
    return img


def visualize_actions(
    location: str,
    actions: np.ndarray,
    num_actions: int = 50,
    use_img: bool = False,
) -> None:
    """Histogram + sphere-coverage map of the actions a policy used.  With
    ``use_img`` the map additionally marks the camera-visible hemisphere
    (reference ``utils.py:592-609``)."""
    os.makedirs(location, exist_ok=True)
    actions = np.asarray(actions).reshape(-1).astype(int)
    write_png(os.path.join(location, "histogram.png"), _histogram_image(actions, num_actions))

    sphere = action_sphere(num_actions)
    canvas = np.zeros((num_actions * 2, num_actions * 4, 3))
    for i in range(num_actions):  # faint grid of all candidate directions
        r, c = _sphere_pixel(sphere[i], num_actions)
        canvas[r - 1 : r + 2, c - 1 : c + 2] += 1.0
    for a in actions:
        r, c = _sphere_pixel(sphere[a], num_actions)
        canvas[r - 1 : r + 2, c - 1 : c + 2] += 1.0
    canvas = canvas * 255.0 / max(canvas.max(), 1e-9)
    if use_img:
        # the camera-visible hemisphere in the green channel, so coverage
        # reads against what the vision tower can see
        for i in np.nonzero(camera_visible_actions(num_actions))[0]:
            r, c = _sphere_pixel(sphere[i], num_actions)
            canvas[r - 1 : r + 2, c - 1 : c + 2, 1] = np.maximum(
                canvas[r - 1 : r + 2, c - 1 : c + 2, 1], 96.0
            )
    canvas[np.all(canvas == 0, axis=-1)] = (0, 204, 204)
    write_png(os.path.join(location, "sphere_projection.png"), canvas)


def _project(cam: PinholeCamera, points) -> np.ndarray:
    """``cam``'s projection of (..., 3) points in numpy, the JAX package's
    host arithmetic (``core/camera.py::project`` with ``xp=np``), so that
    pixels truncate alike."""
    m = cam.matrix
    hom = np.asarray(points) @ m[:, :3].T + m[:, 3]
    z = hom[..., 2]
    z = np.where(z == 0, 1e-1, z)
    return np.stack([hom[..., 0] / z, hom[..., 1] / z, z], axis=-1)


def _splat(cam: PinholeCamera, points, size: int = 256) -> np.ndarray:
    uvz = _project(cam, points)
    img = np.full((size, size, 3), 255, np.uint8)
    u = np.clip(uvz[:, 0].astype(int), 0, size - 1)
    v = np.clip(uvz[:, 1].astype(int), 0, size - 1)
    img[v, u] = POINT_COLOUR
    return img


def _fitted_camera(coords: np.ndarray, fit: bool) -> PinholeCamera:
    """The fixed paper camera, pulled back along its axis when the object
    overflows the frame (objects may be up to 2.2x the ±0.16 canonical
    extent); the model's pooling camera is untouched."""
    cam = PinholeCamera()
    if fit:
        r = float(np.abs(np.asarray(coords)).max())
        k = max(1.0, r / 0.16)
        if k > 1.0:
            cam = PinholeCamera(position=tuple(np.array(cam.position) * k))
    return cam


def render_mesh_image(verts: np.ndarray, faces: np.ndarray, fit: bool = False) -> np.ndarray:
    renderer = SceneRenderer(_fitted_camera(verts, fit))
    return renderer.render([Mesh(verts, faces)], [MESH_COLOUR])


def render_points_image(points: np.ndarray, size: int = 256, fit: bool = False) -> np.ndarray:
    """Splat a point cloud through the scene camera."""
    return _splat(_fitted_camera(points, fit), points, size)


def debug_projection_overlay(
    image: np.ndarray, verts: np.ndarray, out_path: str | None = None
) -> np.ndarray:
    """Splat projected mesh vertices in red onto a rendered scene image, to
    check the camera matrix the projection pooling uses (reference
    ``reconstruction/vision/model.py:105-145`` ``debug_pooling``): red dots
    on the silhouette mean the pooling grid samples the right pixels."""
    img = np.asarray(image).copy()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    size = img.shape[0]
    uvz = _project(PinholeCamera(), np.asarray(verts).reshape(-1, 3))
    u = np.clip(uvz[:, 0].astype(int), 0, size - 1)
    v = np.clip(uvz[:, 1].astype(int), 0, size - 1)
    img[v, u] = (255, 0, 0)
    if out_path is not None:
        write_png(out_path, img)
    return img


def visualize_prediction(
    location: str,
    meshes: np.ndarray,  # (B, V, 3) predicted vertices
    faces: np.ndarray,
    names: list[str],
    gt_points: np.ndarray | None = None,  # (B, N, 3)
) -> list[str]:
    """Render each prediction (and its GT cloud, if given) to
    ``<location>/<name>/prediction.png`` and ``ground_truth_points.png``,
    256x256 (reference ``utils.py:657-668`` + ``pretty_render.py:119-158``).
    Returns the directories."""
    out_dirs = []
    for i, name in enumerate(names):
        short = str(name).rstrip("/").split("/")[-1]
        out = os.path.join(location, short)
        os.makedirs(out, exist_ok=True)
        # prediction and GT through the SAME fitted camera, so the pair is
        # comparable
        ref = gt_points[i] if gt_points is not None else np.asarray(meshes[i])
        cam = _fitted_camera(ref, fit=True)
        write_png(
            os.path.join(out, "prediction.png"),
            SceneRenderer(cam).render(
                [Mesh(np.asarray(meshes[i]), np.asarray(faces))], [MESH_COLOUR]
            ),
        )
        if gt_points is not None:
            write_png(os.path.join(out, "ground_truth_points.png"),
                      _splat(cam, np.asarray(gt_points[i])))
        out_dirs.append(out)
    return out_dirs
