"""One simulated scene: hand + object + touch/vision sensing.

The port's copy of the JAX package's ``sim/scene.py``.

Capability-parity with the reference ``Scene``
(``simulator/scene/instance.py:22-289``), without pybullet/pyrender: FK and
contact come from :mod:`sim.hand`/:mod:`sim.grasp`, rasterization from
:mod:`sim.raster`.
"""

from __future__ import annotations

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera
from active_3d_vision_and_touch_tpu_torch.core.config import SimConfig
from active_3d_vision_and_touch_tpu_torch.core.mesh import Mesh
from active_3d_vision_and_touch_tpu_torch.sim.grasp import AgnosticGrasp
from active_3d_vision_and_touch_tpu_torch.sim.hand import NUM_FINGERS, Hand
from active_3d_vision_and_touch_tpu_torch.sim.raster import (
    focal_from_yfov,
    rasterize_depth,
)
from active_3d_vision_and_touch_tpu_torch.sim.touch_render import depth_to_touch
from active_3d_vision_and_touch_tpu_torch.sim.vision_render import SceneRenderer

TOUCH_YFOV_DEG = 40.0


class Scene:
    """One hand, one object, the fingertip depth cameras (a 40 degree field
    of view) and, with ``vision``, the scene camera.  Under ``tacto=True`` it
    lowers ``config.max_depth`` to at most 0.015 on the caller's
    ``SimConfig`` itself, as the JAX package's scene does, so that both
    packages hand out the same config."""

    def __init__(self, config: SimConfig | None = None, vision: bool = True):
        self.config = config or SimConfig()
        if self.config.tacto:
            # TACTO gels have a shorter sensing range (reference
            # instance.py:46-48)
            self.config.max_depth = min(self.config.max_depth, 0.015)
            from active_3d_vision_and_touch_tpu_torch.sim.tacto import TactoRenderer

            self._tacto = TactoRenderer(
                self.config.touch_resolution, self.config.max_depth
            )
        else:
            self._tacto = None
        self.hand = Hand()
        self.grasper = AgnosticGrasp(self.hand)
        self.vision = vision
        self.renderer = SceneRenderer(PinholeCamera()) if vision else None
        self.obj: Mesh | None = None
        self.depths: np.ndarray | None = None
        self.statuses: list[str] | None = None
        res = self.config.touch_resolution
        self._touch_focal = focal_from_yfov(TOUCH_YFOV_DEG, res)

    # -- object management --------------------------------------------------
    def load_obj(self, verts: np.ndarray, faces: np.ndarray) -> None:
        self.obj = Mesh(verts, faces)
        self.grasper.set_object(self.obj.verts, self.obj.faces)

    def remove_obj(self) -> None:
        self.obj = None
        self.grasper.remove_object()

    # -- grasping ------------------------------------------------------------
    def grasp(self, action: int) -> bool:
        return self.grasper.grasp(int(action))

    def get_hand_pose(self):
        return self.hand.link_poses()

    # -- touch sensing --------------------------------------------------------
    def render_depth(self) -> list[str]:
        """Depth per fingertip camera; 'touch' iff geometry is within the
        sensor range (reference ``instance.py:121-151``)."""
        res = self.config.touch_resolution
        depths = np.zeros((NUM_FINGERS, res, res), np.float32)
        statuses = []
        for f in range(NUM_FINGERS):
            cam_pos, cam_rot = self.hand.fingertip_camera(f)
            depth, _ = rasterize_depth(
                self.obj.verts,
                self.obj.faces,
                cam_pos,
                cam_rot,
                self._touch_focal,
                res,
                res,
            )
            depths[f] = depth
            in_range = (depth > 0) & (depth <= self.config.max_depth)
            statuses.append("touch" if in_range.any() else "no_touch")
        self.depths = depths
        self.statuses = statuses
        return statuses

    def render_touch(self) -> np.ndarray:
        """(4, res, res, 3) gel images from the latest depths."""
        if self._tacto is not None:
            return np.stack([self._tacto.render(d) for d in self.depths])
        return np.stack(
            [depth_to_touch(d, self.config.max_depth) for d in self.depths]
        )

    def depth_to_points(self) -> list[np.ndarray]:
        """Touch-site point clouds in the object frame, one per finger
        (empty array when that finger saw nothing)."""
        res = self.config.touch_resolution
        c = (res - 1) / 2.0
        points = []
        for f in range(NUM_FINGERS):
            if self.statuses[f] != "touch":
                points.append(np.zeros((0, 3), np.float32))
                continue
            depth = self.depths[f]
            mask = (depth > 0) & (depth <= self.config.max_depth)
            ys, xs = np.nonzero(mask)
            z = depth[mask].astype(np.float64)
            x_cam = (xs - c) / self._touch_focal * z
            y_cam = (ys - c) / self._touch_focal * z
            p_cam = np.stack([x_cam, y_cam, z], axis=-1)
            cam_pos, cam_rot = self.hand.fingertip_camera(f)
            points.append((p_cam @ cam_rot + cam_pos).astype(np.float32))
        return points

    def get_finger_frame(self) -> dict:
        """Sensor frames handed to the touch model: rot is sensor→world."""
        pos, rot = [], []
        for f in range(NUM_FINGERS):
            p, r = self.hand.touch_frame(f)
            pos.append(p)
            rot.append(r)
        return {
            "pos": np.asarray(pos, np.float32),
            "rot": np.asarray(rot, np.float32),
        }

    # -- vision ---------------------------------------------------------------
    def scene_render(self, occluded: bool = True) -> np.ndarray:
        meshes = [self.obj]
        colours = [np.asarray(self.config.object_colour, np.float64)]
        if occluded:
            hand_meshes = self.hand.link_meshes()
            meshes += hand_meshes
            colours += [np.array([90.0, 90.0, 95.0])] * len(hand_meshes)
        return self.renderer.render(meshes, colours)
