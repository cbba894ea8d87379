"""The port's host simulator (``sim/``, ``core/actions.py``,
``core/rotations.py``) against the JAX package's.

Both packages run the same numpy, scipy and C++ source on this machine, so
the comparisons are exact unless a docstring says otherwise: the TACTO
renderer is held to 1e-3 of 255 (the port computes OpenCV's blur in numpy),
and the port's rasterizer against its own numpy version to the JAX test's
rule (coverage differs on under 1% of pixels, depths within 1e-4 where both
hit).  Objects are the procedural ones of seeds 0 and 1; the touch and scene
views are full size (121x121, 256x256), which the simulator renders cheaply.
"""

import os
import shutil

import numpy as np
import pytest

from active_3d_vision_and_touch_tpu.core import actions as jax_actions
from active_3d_vision_and_touch_tpu.core import rotations as jax_rotations
from active_3d_vision_and_touch_tpu.sim import Hand as JaxHand
from active_3d_vision_and_touch_tpu.sim import Sampler as JaxSampler
from active_3d_vision_and_touch_tpu.sim import Scene as JaxScene
from active_3d_vision_and_touch_tpu.sim import collision as jax_collision
from active_3d_vision_and_touch_tpu.sim import raster as jax_raster
from active_3d_vision_and_touch_tpu.sim import tacto as jax_tacto
from active_3d_vision_and_touch_tpu.sim import urdf as jax_urdf
from active_3d_vision_and_touch_tpu.sim.touch_render import depth_to_touch as jax_depth_to_touch
from active_3d_vision_and_touch_tpu.sim.vision_render import SceneRenderer as JaxSceneRenderer
from active_3d_vision_and_touch_tpu_torch.core import PinholeCamera, actions, rotations
from active_3d_vision_and_touch_tpu_torch.core.mesh import load_obj
from active_3d_vision_and_touch_tpu_torch.data import random_object
from active_3d_vision_and_touch_tpu_torch.sim import Hand, Sampler, Scene, collision, raster, tacto, urdf
from active_3d_vision_and_touch_tpu_torch.sim.hand import NUM_FINGERS, NUM_JOINTS
from active_3d_vision_and_touch_tpu_torch.sim.touch_render import depth_to_touch
from active_3d_vision_and_touch_tpu_torch.sim.vision_render import SceneRenderer


@pytest.fixture(scope="module")
def objects():
    return [random_object(seed) for seed in (0, 1)]


def _grasped(scene_cls, mesh, action=7):
    scene = scene_cls(vision=True)
    scene.load_obj(mesh.verts, mesh.faces)
    assert scene.grasp(action)
    return scene


def _views(mesh):
    """Three fingertip views of a grasp (121x121) and the scene camera's
    view with the hand in it (256x256): (verts, faces, cam_pos, cam_rot,
    focal, width, height) each."""
    scene = _grasped(Scene, mesh)
    views = []
    for f in range(3):
        pos, rot = scene.hand.fingertip_camera(f)
        views.append((mesh.verts, mesh.faces, pos, rot, scene._touch_focal, 121, 121))
    cam = PinholeCamera()
    hand = scene.hand.link_meshes()
    verts = np.concatenate([mesh.verts] + [m.verts for m in hand])
    offsets = np.cumsum([mesh.num_verts] + [m.num_verts for m in hand])
    faces = np.concatenate([mesh.faces] + [m.faces + o for m, o in zip(hand, offsets[:-1])])
    views.append((verts, faces, np.asarray(cam.position), cam.rotation, cam.focal, 256, 256))
    return views


def test_action_sphere_and_rotations_match_jax():
    np.testing.assert_array_equal(actions.action_sphere(50), jax_actions.action_sphere(50))
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b, c = rng.normal(size=(3, 3))
        q1, q2 = (r / np.linalg.norm(r) for r in rng.normal(size=(2, 4)))
        angles = rng.uniform(-np.pi, np.pi, size=3)
        for name, args in (
            ("normalize", (a,)),
            ("triangle_normal", (a, b, c)),
            ("quat_between", (a, b)),
            ("combine_quats", (q1, q2)),
            ("euler_to_matrix", (angles, c)),
            ("quat_to_matrix", (q1,)),
        ):
            np.testing.assert_array_equal(
                getattr(rotations, name)(*args), getattr(jax_rotations, name)(*args), err_msg=name
            )


def test_hand_kinematics_match_jax():
    """Forward kinematics on random base poses and joint angles: finger
    frames, touch cameras and frames, collision samples, link meshes and
    the link-pose record, equal."""
    rng = np.random.default_rng(1)
    for _ in range(4):
        pos = rng.normal(size=3) * 0.2
        rot = rotations.quat_to_matrix(rotations.normalize(rng.normal(size=4)))
        angles = rng.uniform(0.0, 1.6, size=NUM_JOINTS)
        hands = []
        for cls in (Hand, JaxHand):
            hand = cls()
            hand.set_base(pos, rot)
            hand.joint_angles[:] = angles
            hands.append(hand)
        ours, theirs = hands
        for f in range(NUM_FINGERS):
            for (p, r), (pj, rj) in zip(ours.finger_frames(f), theirs.finger_frames(f)):
                np.testing.assert_array_equal(p, pj)
                np.testing.assert_array_equal(r, rj)
            for name in ("fingertip_camera", "touch_frame"):
                for x, y in zip(getattr(ours, name)(f), getattr(theirs, name)(f)):
                    np.testing.assert_array_equal(x, y, err_msg=name)
            np.testing.assert_array_equal(ours.collision_points(f), theirs.collision_points(f))
        for m, mj in zip(ours.link_meshes(), theirs.link_meshes()):
            np.testing.assert_array_equal(m.verts, mj.verts)
            np.testing.assert_array_equal(m.faces, mj.faces)
        for (p, e), (pj, ej) in zip(ours.link_poses(), theirs.link_poses()):
            np.testing.assert_array_equal(p, pj)
            np.testing.assert_array_equal(e, ej)


def test_solid_occupancy_matches_jax(objects):
    for mesh in objects:
        np.testing.assert_array_equal(
            collision.subdivide_to_density(mesh.verts, mesh.faces, 0.01),
            jax_collision.subdivide_to_density(mesh.verts, mesh.faces, 0.01),
        )
        grid = collision.solid_occupancy(mesh.verts, mesh.faces)
        jgrid = jax_collision.solid_occupancy(mesh.verts, mesh.faces)
        np.testing.assert_array_equal(grid.occ, jgrid.occ)
        np.testing.assert_array_equal(grid.origin, jgrid.origin)
        assert grid.cell == jgrid.cell
        pts = np.random.default_rng(2).uniform(-0.2, 0.2, size=(500, 3))
        np.testing.assert_array_equal(grid.contains(pts), jgrid.contains(pts))


def test_grasps_match_jax(objects):
    """``AgnosticGrasp.grasp`` on all 50 actions of 2 objects: the same
    success flags, base poses and joint angles."""
    scene, jscene = Scene(vision=False), JaxScene(vision=False)
    touched = 0
    for mesh in objects:
        scene.load_obj(mesh.verts, mesh.faces)
        jscene.load_obj(mesh.verts, mesh.faces)
        for action in range(50):
            assert scene.grasp(action) == jscene.grasp(action)
            np.testing.assert_array_equal(scene.hand.base_pos, jscene.hand.base_pos)
            np.testing.assert_array_equal(scene.hand.base_rot, jscene.hand.base_rot)
            np.testing.assert_array_equal(scene.hand.joint_angles, jscene.hand.joint_angles)
            touched += int((scene.hand.joint_angles > 0).any())
    assert touched > 50


def test_rasterizer_matches_jax(objects):
    """The port's library against the JAX package's (both built by the same
    g++ with the same flags from the same source): depth and face ids
    equal; the numpy versions equal; the port's library against its numpy
    version by the JAX test's rule."""
    assert jax_raster.native_available()
    for view in _views(objects[0]):
        native = raster.rasterize_depth(*view)
        plain = raster.rasterize_depth(*view, use_native=False)
        for got, want in zip(native, jax_raster.rasterize_depth(*view, use_native=True)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(plain, jax_raster.rasterize_depth(*view, use_native=False)):
            np.testing.assert_array_equal(got, want)
        (d1, i1), (d2, i2) = plain, native
        both = (i1 >= 0) & (i2 >= 0)
        assert both.sum() > 100
        assert ((i1 >= 0) != (i2 >= 0)).mean() < 0.01
        assert np.allclose(d1[both], d2[both], atol=1e-4)


def test_ray_mesh_intersections_match_jax(objects, monkeypatch):
    """Both routes against the JAX package's: the library's hits equal the
    JAX library's, the numpy version's equal the JAX numpy route's."""
    from scipy.spatial import ConvexHull

    mesh = objects[1]
    hull = ConvexHull(mesh.verts.astype(np.float64)).simplices.astype(np.int32)
    rays = [(np.zeros(3), d) for d in -actions.action_sphere(50)[:10]]
    rays.append((np.array([0.5, 0.01, 0.02]), np.array([-1.0, 0.0, 0.0])))  # through both sides
    native = [raster.ray_mesh_intersections(mesh.verts, hull, o, d) for o, d in rays]
    plain = [raster.ray_mesh_intersections(mesh.verts, hull, o, d, use_native=False) for o, d in rays]
    jax_native = [jax_raster.ray_mesh_intersections(mesh.verts, hull, o, d) for o, d in rays]
    monkeypatch.setattr(jax_raster, "_load_library", lambda: None)
    jax_plain = [jax_raster.ray_mesh_intersections(mesh.verts, hull, o, d) for o, d in rays]
    assert len(native[-1][0]) == 2
    for ours, theirs in ((native, jax_native), (plain, jax_plain)):
        for (t, f), (tj, fj) in zip(ours, theirs):
            np.testing.assert_array_equal(t, tj)
            np.testing.assert_array_equal(f, fj)


def test_the_default_raster_route_is_the_library(objects, tmp_path, monkeypatch):
    """The default route calls the library built under the build directory;
    a source that does not compile raises with the compiler's message, and
    nothing falls back to numpy.  Only ``use_native=False`` takes it."""
    view = _views(objects[0])[0]
    monkeypatch.setattr(raster, "_rasterize_numpy", None)
    monkeypatch.setattr(raster, "_ray_mesh_numpy", None)
    depth, _ = raster.rasterize_depth(*view)
    assert raster.library_path().exists() and (depth > 0).any()
    raster.ray_mesh_intersections(objects[0].verts, objects[0].faces, np.zeros(3), np.ones(3))
    monkeypatch.undo()

    broken = tmp_path / "raster.cpp"
    broken.write_text(raster.SOURCE.read_text().replace("extern \"C\" {", "extern \"C\" { syntax error;"))
    monkeypatch.setattr(raster, "SOURCE", broken)
    monkeypatch.setattr(raster, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        raster.rasterize_depth(*view)
    with pytest.raises(RuntimeError, match="error"):
        raster.ray_mesh_intersections(objects[0].verts, objects[0].faces, np.zeros(3), np.ones(3))
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary left
    plain, _ = raster.rasterize_depth(*view, use_native=False)
    assert ((plain > 0) != (depth > 0)).mean() < 0.01


def test_depth_to_touch_matches_jax(objects):
    scene = _grasped(Scene, objects[0])
    scene.render_depth()
    assert any(s == "touch" for s in scene.statuses)
    for depth in scene.depths:
        np.testing.assert_array_equal(depth_to_touch(depth), jax_depth_to_touch(depth))


def test_tacto_blur_is_opencvs():
    """The port's blur against ``cv2.GaussianBlur(img, (7, 7), 0)`` on 0-255
    images, one and three channels: within 1e-3 absolute (float32 sums in
    another order)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for shape in ((121, 121, 3), (121, 121), (40, 57, 3)):
        img = rng.uniform(0, 255, size=shape).astype(np.float32)
        np.testing.assert_allclose(tacto._gaussian_blur(img), cv2.GaussianBlur(img, (7, 7), 0),
                                   rtol=0, atol=1e-3)


def test_tacto_renderer_matches_jax_with_opencv(objects):
    """``TactoRenderer.render`` with noise and calibration against the JAX
    renderer, which blurs with OpenCV when ``cv2`` imports (it does here):
    within 1e-3 absolute on 0-255; without calibration, equal."""
    pytest.importorskip("cv2")
    assert jax_tacto.cv2 is not None
    scene = _grasped(Scene, objects[0])
    scene.render_depth()
    renderer, jrenderer = tacto.TactoRenderer(), jax_tacto.TactoRenderer()
    for depth in scene.depths:
        np.testing.assert_allclose(renderer.render(depth), jrenderer.render(depth), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(renderer.render(depth, noise=False, calibration=False),
                                      jrenderer.render(depth, noise=False, calibration=False))


def test_tacto_scene_lowers_the_callers_max_depth():
    from active_3d_vision_and_touch_tpu_torch.core.config import SimConfig

    config = SimConfig(tacto=True)
    Scene(config, vision=False)
    assert config.max_depth == 0.015


def test_scene_renderer_and_touch_points_match_jax(objects):
    """The scene image (uint8, occluded and not) and the touch-site clouds
    of a grasp, equal."""
    scene, jscene = _grasped(Scene, objects[1], 20), _grasped(JaxScene, objects[1], 20)
    for occluded in (False, True):
        np.testing.assert_array_equal(scene.scene_render(occluded), jscene.scene_render(occluded))
    scene.render_depth()
    jscene.render_depth()
    assert scene.statuses == jscene.statuses
    for p, pj in zip(scene.depth_to_points(), jscene.depth_to_points()):
        np.testing.assert_array_equal(p, pj)
    mesh = objects[1]
    colour = np.array([228.0, 217.0, 111.0])
    np.testing.assert_array_equal(SceneRenderer().render([mesh], [colour]),
                                  JaxSceneRenderer().render([mesh], [colour]))


def test_sampler_matches_jax(objects):
    """``Sampler.sample`` on 2 objects x 3 actions with touch, touch point
    clouds, vision and the occluded view: every key equal."""
    sampler, jsampler = Sampler(bs=2), JaxSampler(bs=2)
    specs = [(m.verts, m.faces) for m in objects]
    sampler.load_objects(specs)
    jsampler.load_objects(specs)
    kw = dict(touch=True, touch_point_cloud=True, vision=True, vision_occluded=True)
    for actions_ in ([0, 1], [7, 30], [49, 12]):
        ours, theirs = sampler.sample(actions_, **kw), jsampler.sample(actions_, **kw)
        assert ours.keys() == theirs.keys()
        assert ours["grasp_success"] == theirs["grasp_success"]
        assert ours["touch_status"] == theirs["touch_status"]
        for key in ("touch_signal", "depths", "finger_transform_pos", "finger_transform_rot_M"):
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        for key in ("vision", "vision_occluded"):
            for a, b in zip(ours[key], theirs[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
        for clouds, jclouds in zip(ours["touch_point_cloud"], theirs["touch_point_cloud"]):
            for a, b in zip(clouds, jclouds):
                np.testing.assert_array_equal(a, b)
        for poses, jposes in zip(ours["hand_pose"], theirs["hand_pose"]):
            assert (poses is None) == (jposes is None)
            for (p, e), (pj, ej) in zip(poses or [], jposes or []):
                np.testing.assert_array_equal(p, pj)
                np.testing.assert_array_equal(e, ej)
    sampler.disconnect()
    jsampler.disconnect()


def test_sampler_loads_dataset_prefixes_and_obj_files(objects, tmp_path):
    from active_3d_vision_and_touch_tpu_torch.core.mesh import save_obj

    mesh = objects[0]
    np.save(tmp_path / "a_verts.npy", mesh.verts)
    np.save(tmp_path / "a_faces.npy", mesh.faces)
    save_obj(str(tmp_path / "b.obj"), mesh.verts, mesh.faces)
    sampler = Sampler(bs=1, vision=False)
    for spec, from_dataset in ((str(tmp_path / "a"), True), (str(tmp_path / "b"), False)):
        sampler.load_objects([spec], from_dataset=from_dataset)
        assert sampler.scenes[0].obj.num_faces == mesh.num_faces
        assert sampler.sample([3])["grasp_success"] == [True]
    sampler.disconnect()


def test_urdf_round_trip_matches_jax(objects, tmp_path):
    """An object's URDF and a grasped hand's URDF: the files the JAX package
    writes at the same paths, byte for byte, and the meshes they name read
    back to the hand's link meshes within the OBJ's six decimals."""
    from active_3d_vision_and_touch_tpu_torch.core.mesh import save_obj

    mesh = objects[0]
    obj_path = str(tmp_path / "object.obj")
    save_obj(obj_path, mesh.verts, mesh.faces)
    scene = _grasped(Scene, mesh)
    written = {}
    for side, module in (("jax", jax_urdf), ("port", urdf)):
        out = tmp_path / "out"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir()
        obj_urdf = module.export_object_urdf(obj_path, str(out / "object.urdf"))
        hand_urdf = module.export_hand_urdf(scene.hand, str(out / "hand"))
        written[side] = {
            os.path.relpath(os.path.join(d, f), out): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(out) for f in files
        }
        # each link names its mesh twice: visual and collision
        assert module.load_urdf_mesh_paths(obj_urdf) == [os.path.abspath(obj_path)] * 2
    assert written["port"] == written["jax"]
    paths = urdf.load_urdf_mesh_paths(hand_urdf)
    links = scene.hand.link_meshes()
    assert paths[::2] == paths[1::2] and len(paths) == 2 * len(links)
    for path, link in zip(paths[::2], links):
        back = load_obj(path)
        np.testing.assert_array_equal(back.faces, link.faces)
        np.testing.assert_allclose(back.verts, link.verts, rtol=0, atol=1e-6)
