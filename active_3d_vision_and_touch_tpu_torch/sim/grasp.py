"""Object-agnostic grasp controller.

The port's copy of the JAX package's ``sim/grasp.py``.

Action index → hand approach direction → placement on the object's convex
hull → finger curl until contact.  Capability-parity with the reference's
``Agnostic_Grasp`` (``simulator/physics/grasping.py:14-139``):

- 50 approach directions = the negated action sphere,
- a ray from the object center is intersected with the convex hull
  (scipy Qhull + our native Möller–Trumbore instead of trimesh/rtree),
- the hand is posed ``hand_distance`` above the farthest hull hit with its
  -x axis aligned to the outward face normal, offset so the canonical
  fingertip sits at the contact point,
- fingers then curl toward the palm normal until each joint's link samples
  contact the solid occupancy grid (stand-in for Bullet position control
  stopping on collision, ``grasping.py:54-64``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

from active_3d_vision_and_touch_tpu_torch.core.actions import action_sphere
from active_3d_vision_and_touch_tpu_torch.core.rotations import (
    combine_quats,
    quat_between,
    quat_to_matrix,
    triangle_normal,
)
from active_3d_vision_and_touch_tpu_torch.sim.collision import OccupancyGrid, solid_occupancy
from active_3d_vision_and_touch_tpu_torch.sim.hand import (
    FINGERTIP_REACH,
    JOINTS_PER_FINGER,
    NUM_FINGERS,
    Hand,
)
from active_3d_vision_and_touch_tpu_torch.sim.raster import ray_mesh_intersections


class AgnosticGrasp:
    def __init__(self, hand: Hand, num_actions: int = 50):
        self.hand = hand
        self.directions = -action_sphere(num_actions)
        self.hull_verts: np.ndarray | None = None
        self.hull_faces: np.ndarray | None = None
        self.occupancy: OccupancyGrid | None = None

    def set_object(self, verts: np.ndarray, faces: np.ndarray) -> None:
        hull = ConvexHull(np.asarray(verts, np.float64))
        self.hull_verts = np.asarray(verts, np.float32)
        self.hull_faces = np.asarray(hull.simplices, np.int32)
        self.occupancy = solid_occupancy(verts, faces)

    def remove_object(self) -> None:
        self.hull_verts = None
        self.hull_faces = None
        self.occupancy = None

    def grasp(self, action: int, hand_distance: float = 0.013) -> bool:
        """Pose the hand for ``action`` and curl the fingers; False if the
        approach ray misses the hull."""
        self.hand.reset()
        direction = self.directions[int(action)]
        if not self._place_hand(direction, hand_distance):
            return False
        self._close_fingers()
        return True

    def _place_hand(self, direction, hand_distance: float) -> bool:
        ts, face_ids = ray_mesh_intersections(
            self.hull_verts, self.hull_faces, np.zeros(3), direction
        )
        if len(ts) == 0:
            return False
        far = int(np.argmax(ts))
        point = np.asarray(direction, np.float64) * float(ts[far])
        face = self.hull_faces[face_ids[far]]
        normal = triangle_normal(
            self.hull_verts[face[0]], self.hull_verts[face[1]], self.hull_verts[face[2]]
        )
        # orient outward (away from the object center)
        if np.dot(normal, point) < 0:
            normal = -normal
        contact = point + normal * hand_distance

        # hand -x axis → outward normal; palm (+x) faces the object
        quat = quat_between([-1.0, 0.0, 0.0], normal)
        rot = quat_to_matrix(quat)
        position = contact - rot @ np.array([0.0, 0.0, FINGERTIP_REACH])
        self.hand.set_base(position, rot)
        return True

    def _close_fingers(
        self, step: float = 0.06, max_steps: int = 30, samples_per_link: int = 5
    ) -> None:
        """Curl every joint toward the palm until contact or joint limit."""
        active = np.ones((NUM_FINGERS, JOINTS_PER_FINGER), bool)
        for _ in range(max_steps):
            moved = False
            for f in range(NUM_FINGERS):
                limit = self.hand.fingers[f].joint_limit
                for j in range(JOINTS_PER_FINGER):
                    if not active[f, j]:
                        continue
                    k = f * JOINTS_PER_FINGER + j
                    old = self.hand.joint_angles[k]
                    new = min(old + step, limit)
                    if new == old:
                        active[f, j] = False
                        continue
                    self.hand.joint_angles[k] = new
                    pts = self.hand.collision_points(f, samples_per_link)
                    if self.occupancy.contains(pts).any():
                        self.hand.joint_angles[k] = old  # contact: back off
                        active[f, j] = False
                    else:
                        moved = True
            if not moved:
                break
