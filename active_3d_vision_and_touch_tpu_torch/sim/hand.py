"""The simulated multi-finger hand: kinematics, geometry, touch sensors.

The port's copy of the JAX package's ``sim/hand.py``.

An original, procedurally defined 4-finger hand playing the role the
reference fills with the Allegro-hand URDF + pybullet forward kinematics
(``simulator/scene/instance.py:33-43``, asset ``objects/hand/
allegro_hand.urdf``).  Geometry is deliberately simple (box palm, capsule
finger links) — the grasping behavior that matters downstream is "fingers
curl toward the palm normal until they contact the object", and every
fingertip carries a touch camera.

Conventions (hand/base frame):
- the palm faces +x (the grasp/approach direction); the reference's
  placement math aligns the hand's -x axis with the outward surface normal
  (``physics/grasping.py:95``), which this hand reproduces,
- fingers extend along +z, spaced along y; the canonical fingertip (finger
  index 1, the one used in single-finger experiments) reaches
  (0, 0, FINGERTIP_REACH) at rest — the reference's hard-coded fingertip
  offset (``grasping.py:100-104``),
- finger joints are revolute about the local +y axis; positive angles curl
  the finger toward +x (the palm normal).

Touch sensor frame per fingertip: forward (+z of the depth camera) points
along the fingertip pad normal (+x of the tip link); image right = tip +y,
image down = tip -z.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.mesh import Mesh

FINGERTIP_REACH = 0.133  # rest-pose z of the canonical fingertip
NUM_FINGERS = 4
JOINTS_PER_FINGER = 3
NUM_JOINTS = NUM_FINGERS * JOINTS_PER_FINGER
CANONICAL_FINGER = 1  # the "single finger" of p-settings


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _box_mesh(extents, center=(0, 0, 0)) -> Mesh:
    ex, ey, ez = np.asarray(extents) / 2.0
    cx, cy, cz = center
    verts = np.array(
        [
            [sx * ex + cx, sy * ey + cy, sz * ez + cz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
            [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
            [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
        ],
        np.int32,
    )
    return Mesh(verts, faces)


def _capsule_mesh(length: float, radius: float, segments: int = 6) -> Mesh:
    """Prism approximation of a capsule along +z from 0 to length."""
    angles = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.cos(angles) * radius, np.sin(angles) * radius], axis=-1)
    bottom = np.concatenate([ring, np.full((segments, 1), -radius * 0.5)], axis=-1)
    top = np.concatenate([ring, np.full((segments, 1), length + radius * 0.5)], axis=-1)
    verts = np.concatenate([bottom, top, [[0, 0, -radius], [0, 0, length + radius]]])
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, j, segments + i], [j, segments + j, segments + i]]
        faces += [[2 * segments, j, i], [2 * segments + 1, segments + i, segments + j]]
    return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


@dataclass
class FingerSpec:
    root: np.ndarray  # (3,) attachment point on the palm (hand frame)
    link_lengths: tuple = (0.047, 0.046, 0.04)
    radius: float = 0.008
    rest_angles: tuple = (0.0, 0.0, 0.0)
    joint_limit: float = 1.6


def default_hand_spec() -> list[FingerSpec]:
    """Index/middle/ring along +z spaced in y, thumb offset and pre-curled
    to oppose (the reference parks thumb joints at 1.2/0.7 rad,
    ``grasping.py:130-139``)."""
    reach = FINGERTIP_REACH
    l1, l2, l3 = 0.047, 0.046, 0.04  # sums to 0.133 = reach
    assert abs(l1 + l2 + l3 - reach) < 1e-9
    fingers = [
        FingerSpec(root=np.array([0.0, -0.045, 0.0])),
        FingerSpec(root=np.array([0.0, 0.0, 0.0])),  # canonical fingertip
        FingerSpec(root=np.array([0.0, 0.045, 0.0])),
        FingerSpec(
            root=np.array([0.0, 0.0, -0.06]),
            rest_angles=(0.9, 0.4, 0.0),
            joint_limit=1.6,
        ),
    ]
    return fingers


@dataclass
class Hand:
    """Kinematic state: base pose + 12 joint angles, FK, collision samples."""

    fingers: list[FingerSpec] = field(default_factory=default_hand_spec)
    base_pos: np.ndarray = field(default_factory=lambda: np.array([20.0, 0.0, 0.0]))
    base_rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    palm_extents: tuple = (0.02, 0.12, 0.10)

    def __post_init__(self):
        self.joint_angles = np.zeros(NUM_JOINTS)
        self.reset()

    def reset(self):
        """Park far away with rest joint angles (reference ``reset_hand``)."""
        self.base_pos = np.array([20.0, 0.0, 0.0])
        self.base_rot = np.eye(3)
        for f, spec in enumerate(self.fingers):
            for j in range(JOINTS_PER_FINGER):
                self.joint_angles[f * JOINTS_PER_FINGER + j] = spec.rest_angles[j]

    def set_base(self, position, rotation):
        self.base_pos = np.asarray(position, np.float64)
        self.base_rot = np.asarray(rotation, np.float64)

    def finger_frames(self, finger: int):
        """FK of one finger → list of (origin (3,), rot (3,3)) per link, in
        the world frame, plus the fingertip frame at the end."""
        spec = self.fingers[finger]
        pos = self.base_pos + self.base_rot @ spec.root
        rot = self.base_rot.copy()
        frames = []
        for j, length in enumerate(spec.link_lengths):
            theta = self.joint_angles[finger * JOINTS_PER_FINGER + j]
            rot = rot @ _rot_y(theta)
            frames.append((pos.copy(), rot.copy()))
            pos = pos + rot @ np.array([0.0, 0.0, length])
        frames.append((pos, rot))  # fingertip frame
        return frames

    def fingertip_camera(self, finger: int):
        """(cam_pos (3,), cam_rot (3,3) world→camera) of the touch sensor.

        Camera forward = tip-link +x (pad normal), right = tip +y,
        down = tip -z; positioned at the pad surface.
        """
        tip_pos, tip_rot = self.finger_frames(finger)[-1]
        spec = self.fingers[finger]
        forward = tip_rot[:, 0]
        right = tip_rot[:, 1]
        down = -tip_rot[:, 2]
        cam_pos = tip_pos + forward * spec.radius * 0.5
        cam_rot = np.stack([right, down, forward], axis=0)  # world→camera rows
        return cam_pos, cam_rot

    def touch_frame(self, finger: int):
        """(pos, rot) reference frame handed to the touch-chart model:
        rot maps sensor-frame coordinates to world (camera→world)."""
        cam_pos, cam_rot = self.fingertip_camera(finger)
        return cam_pos, cam_rot.T

    def collision_points(self, finger: int, samples_per_link: int = 5):
        """World-space sample points along the finger capsules (pad side),
        used for contact detection while curling."""
        spec = self.fingers[finger]
        pts = []
        frames = self.finger_frames(finger)
        for j, length in enumerate(spec.link_lengths):
            origin, rot = frames[j]
            for t in np.linspace(0.25, 1.0, samples_per_link):
                center = origin + rot @ np.array([0.0, 0.0, t * length])
                pts.append(center + rot @ np.array([spec.radius, 0.0, 0.0]))
                pts.append(center)
        return np.asarray(pts)

    def link_meshes(self) -> list[Mesh]:
        """World-space meshes of every hand part (palm + finger links),
        used to occlude the scene camera (reference shows/hides 21 hand
        meshes, ``vision_renderer.py:133-173``)."""
        meshes = []
        palm = _box_mesh(self.palm_extents, center=(-0.01, 0.0, -0.045))
        meshes.append(
            Mesh(palm.verts @ self.base_rot.T.astype(np.float32) + self.base_pos.astype(np.float32), palm.faces)
        )
        for f, spec in enumerate(self.fingers):
            frames = self.finger_frames(f)
            for j, length in enumerate(spec.link_lengths):
                origin, rot = frames[j]
                cap = _capsule_mesh(length, spec.radius)
                verts = cap.verts @ rot.T.astype(np.float32) + origin.astype(
                    np.float32
                )
                meshes.append(Mesh(verts, cap.faces))
        return meshes

    def link_poses(self):
        """(pos, euler-xyz) for every link frame — the hand-pose record
        (reference ``Scene.get_hand_pose``, ``instance.py:70-84``)."""
        from scipy.spatial.transform import Rotation as R

        poses = [(self.base_pos.copy(), R.from_matrix(self.base_rot).as_euler("xyz"))]
        for f in range(NUM_FINGERS):
            for pos, rot in self.finger_frames(f):
                poses.append((pos, R.from_matrix(rot).as_euler("xyz")))
        return poses
