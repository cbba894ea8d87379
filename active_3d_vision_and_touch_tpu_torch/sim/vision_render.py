"""Scene RGB renderer: flat-shaded rasterization with point lights.

The port's copy of the JAX package's ``sim/vision_render.py``.

Renders the object (and optionally the hand, for occluded views) from the
shared :class:`core.camera.PinholeCamera` — the same camera whose matrix
the vision model pools image features through, so observation and model
can never disagree.  Replaces the reference's pyrender scene camera
(``simulator/rendering/vision_renderer.py:21-192``).
"""

from __future__ import annotations

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera
from active_3d_vision_and_touch_tpu_torch.core.mesh import Mesh
from active_3d_vision_and_touch_tpu_torch.sim.raster import rasterize_depth

LIGHT_POSITIONS = np.array(
    [[0.4, 0.4, 0.4], [-0.4, 0.4, 0.4], [0.4, -0.4, 0.4], [-0.4, -0.4, 0.4]]
)
AMBIENT = 0.25
DIFFUSE = 0.75
BACKGROUND = np.array([255.0, 255.0, 255.0])


class SceneRenderer:
    def __init__(self, camera: PinholeCamera | None = None):
        self.camera = camera or PinholeCamera()

    def render(self, meshes: list[Mesh], colours: list[np.ndarray]) -> np.ndarray:
        """Flat-shaded (H, W, 3) uint8 image of the given meshes."""
        cam = self.camera
        verts = np.concatenate([m.verts for m in meshes], axis=0)
        offsets = np.cumsum([0] + [m.num_verts for m in meshes])
        faces = np.concatenate(
            [m.faces + offsets[i] for i, m in enumerate(meshes)], axis=0
        )
        face_colour = np.concatenate(
            [
                np.broadcast_to(np.asarray(c, np.float64)[:3], (m.num_faces, 3))
                for m, c in zip(meshes, colours)
            ],
            axis=0,
        )

        depth, face_id = rasterize_depth(
            verts,
            faces,
            np.asarray(cam.position),
            cam.rotation,
            cam.focal,
            cam.width,
            cam.height,
        )
        img = np.broadcast_to(BACKGROUND, (cam.height, cam.width, 3)).copy()
        hit = face_id >= 0
        if not hit.any():
            return img.astype(np.uint8)

        fid = face_id[hit]
        # flat per-face normals
        tri = verts[faces[fid]]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

        # world positions from depth unprojection
        ys, xs = np.nonzero(hit)
        z = depth[hit]
        x_cam = (xs + 0.0 - cam.width / 2.0) / cam.focal * z
        y_cam = (ys + 0.0 - cam.height / 2.0) / cam.focal * z
        p_cam = np.stack([x_cam, y_cam, z], axis=-1)
        p_world = p_cam @ cam.rotation + np.asarray(cam.position)

        shade = np.full(len(fid), AMBIENT)
        for light in LIGHT_POSITIONS:
            l_dir = light - p_world
            l_dir = l_dir / np.maximum(np.linalg.norm(l_dir, axis=1, keepdims=True), 1e-12)
            # double-sided flat shading
            shade += DIFFUSE / len(LIGHT_POSITIONS) * np.abs((n * l_dir).sum(1))
        img[hit] = np.clip(face_colour[fid] * np.clip(shade, 0, 1)[:, None], 0, 255)
        return img.astype(np.uint8)
