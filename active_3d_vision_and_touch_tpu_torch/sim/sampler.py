"""Batched simulator façade: N scenes, one signal dict.

The port's copy of the JAX package's ``sim/sampler.py``.

The single entry point everything above the simulator uses (environment,
data generation), with the same signal contract as the reference
``Sampler`` (``simulator/scene/sampler.py:17-175``) — numpy instead of
torch, corrected key spellings, and a thread pool instead of N sequential
pybullet clients (scenes are independent; the rasterizer releases the GIL).

Signal dict keys (shapes for batch size B, 4 fingers, res 121):
- ``hand_pose``:        list[B] of link-pose lists (or None on failure)
- ``touch_status``:     list[B][4] of 'touch' | 'no_touch' | 'no_intersection'
- ``touch_signal``:     (B, 4, 121, 121, 3) float32 gel images (0..255)
- ``depths``:           (B, 4, 121, 121) float32
- ``finger_transform_pos``:   (B, 4, 3) float32 sensor origins
- ``finger_transform_rot_M``: (B, 4, 3, 3) float32 sensor→world rotations
- ``touch_point_cloud``: list[B] of list[4] (Ni, 3) arrays (on request)
- ``vision`` / ``vision_occluded``: list[B] (256, 256, 3) uint8 (on request)

Spans (``utils/profiler.py``, recorded under a profiler, on the calling
thread around the pool's work): ``sim.load_objects``, ``sim.sample``.
Counters: ``sim.objects_loaded``, ``sim.grasps``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.config import SimConfig
from active_3d_vision_and_touch_tpu_torch.core.mesh import load_obj
from active_3d_vision_and_touch_tpu_torch.sim.scene import Scene
from active_3d_vision_and_touch_tpu_torch.utils.profiler import count, span


class Sampler:
    def __init__(
        self,
        bs: int = 1,
        vision: bool = True,
        config: SimConfig | None = None,
    ):
        self.config = config or SimConfig()
        self.bs = bs
        self.vision = vision
        self.scenes = [Scene(self.config, vision=vision) for _ in range(bs)]
        self._pool = ThreadPoolExecutor(max_workers=min(bs, self.config.workers))

    def disconnect(self) -> None:
        self._pool.shutdown(wait=False)

    def _map(self, fn, *iterables):
        return list(self._pool.map(fn, *iterables))

    # -- objects ---------------------------------------------------------------
    def load_objects(self, batch, from_dataset: bool = True) -> None:
        """``batch``: B object specs — either path prefixes to
        ``<prefix>_verts.npy`` / ``<prefix>_faces.npy`` (from_dataset=True,
        the dataset layout), ``.obj`` paths, or (verts, faces) tuples."""
        assert len(batch) == self.bs

        def load(args):
            scene, spec = args
            if isinstance(spec, tuple):
                verts, faces = spec
            elif from_dataset:
                verts = np.load(spec + "_verts.npy")
                faces = np.load(spec + "_faces.npy")
            else:
                mesh = load_obj(spec if spec.endswith(".obj") else spec + ".obj")
                verts, faces = mesh.verts, mesh.faces
            scene.load_obj(verts, faces)

        with span("sim.load_objects"):
            self.remove_objects()
            self._map(load, zip(self.scenes, batch))
        count("sim.objects_loaded", self.bs)

    def remove_objects(self) -> None:
        for scene in self.scenes:
            if scene.obj is not None:
                scene.remove_obj()

    # -- the batched step --------------------------------------------------------
    def sample(
        self,
        actions,
        touch: bool = True,
        touch_point_cloud: bool = False,
        vision: bool = False,
        vision_occluded: bool = False,
    ) -> dict:
        actions = np.asarray(actions).reshape(self.bs)
        count("sim.grasps", self.bs)
        with span("sim.sample"):
            res = self.config.touch_resolution
            signals: dict = {}

            def run_grasp(args):
                scene, action = args
                return scene.grasp(int(action))

            success = self._map(run_grasp, zip(self.scenes, actions))
            signals["grasp_success"] = success
            signals["hand_pose"] = [
                s.get_hand_pose() if ok else None for s, ok in zip(self.scenes, success)
            ]

            if touch:
                status = [["no_intersection"] * 4 for _ in range(self.bs)]
                touch_signal = np.zeros((self.bs, 4, res, res, 3), np.float32)
                depths = np.zeros((self.bs, 4, res, res), np.float32)
                pos = np.zeros((self.bs, 4, 3), np.float32)
                rot = np.zeros((self.bs, 4, 3, 3), np.float32)
                clouds = [[np.zeros((0, 3), np.float32)] * 4 for _ in range(self.bs)]

                def sense(i):
                    if not success[i]:
                        return
                    scene = self.scenes[i]
                    status[i] = scene.render_depth()
                    touch_signal[i] = scene.render_touch()
                    depths[i] = scene.depths
                    frame = scene.get_finger_frame()
                    pos[i] = frame["pos"]
                    rot[i] = frame["rot"]
                    if touch_point_cloud:
                        clouds[i] = scene.depth_to_points()

                self._map(sense, range(self.bs))
                signals["touch_status"] = status
                signals["touch_signal"] = touch_signal
                signals["depths"] = depths
                signals["finger_transform_pos"] = pos
                signals["finger_transform_rot_M"] = rot
                if touch_point_cloud:
                    signals["touch_point_cloud"] = clouds

            if vision_occluded:
                signals["vision_occluded"] = self._map(
                    lambda s: s.scene_render(occluded=True), self.scenes
                )
            if vision:
                signals["vision"] = self._map(
                    lambda s: s.scene_render(occluded=False), self.scenes
                )
            return signals
