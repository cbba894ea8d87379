"""The port's trainer datasets and mesh I/O against the JAX package's, and
the touch trainer fed from disk.

The dataset is written here from numpy in the JAX package's layout: five
objects with 32x32 images, 200-point clouds, a chart cache of 6 actions,
and grasp directories of gel images (121x121), touch point clouds and
reference frames; a data split over the training, validation and test
splits.  No simulator runs.
"""

import os

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.core import mesh as jax_mesh
from active_3d_vision_and_touch_tpu.data.datasets import Loader as JaxLoader
from active_3d_vision_and_touch_tpu.data.datasets import TouchDataset as JaxTouchDataset
from active_3d_vision_and_touch_tpu.data.datasets import VisionDataset as JaxVisionDataset
from active_3d_vision_and_touch_tpu_torch.core import mesh
from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.data import (
    Loader,
    TouchDataset,
    VisionDataset,
    object_dirs,
)
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

NAMES = [f"{i:06d}" for i in range(5)]
ACTIONS, POINTS, GRASPS = 6, 200, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small torch ops beside other test processes: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Per object: image, cloud, a chart cache (actions, 4, 25, xyz | code),
    and two or three grasps whose fingers hold a touch (gel image, a local
    cloud of 30 to 90 points, fewer than a touch trainer's sample count for
    some, and the sensor's frame)."""
    root = str(tmp_path_factory.mktemp("dataset"))
    rng = np.random.default_rng(0)
    dirs = object_dirs(root)
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for n in NAMES:
        np.save(os.path.join(dirs["images_colourful"], n + ".npy"),
                rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8))
        np.save(os.path.join(dirs["point_cloud_info"], n + ".npy"),
                rng.normal(size=(POINTS, 3)).astype(np.float32) * 0.1)
        charts = rng.normal(size=(ACTIONS, 4, 25, 4)).astype(np.float32) * 0.1
        charts[..., 3] = rng.integers(0, 3, size=(ACTIONS, 4, 1))
        os.makedirs(os.path.join(dirs["touch_charts"], n))
        np.save(os.path.join(dirs["touch_charts"], n, "touch_charts.npy"), charts)
        for grasp in rng.choice(ACTIONS, size=rng.integers(2, 4), replace=False):
            gdir = os.path.join(dirs["grasp_info"], n, str(grasp))
            os.makedirs(gdir)
            for finger in rng.choice(4, size=rng.integers(1, 4), replace=False):
                np.save(os.path.join(gdir, f"{finger}_touch.npy"),
                        rng.integers(0, 256, size=(121, 121, 3)).astype(np.uint8))
                np.save(os.path.join(gdir, f"{finger}_points.npy"),
                        rng.normal(size=(rng.integers(30, 90), 3)).astype(np.float32) * 0.003)
                rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
                np.save(os.path.join(gdir, f"{finger}_ref_frame.npy"),
                        {"pos": rng.normal(size=3) * 0.1, "rot": rot}, allow_pickle=True)
    np.save(os.path.join(root, "data_split.npy"),
            {"recon_train": NAMES[:3], "auto_train": NAMES[:3], "valid": NAMES[3:], "test": NAMES[3:]})
    return root


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    assert a["names"] == b["names"]
    for key in a:
        if key != "names":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("num_samples", [50, 120])
def test_touch_dataset_matches_jax(root, num_samples):
    """The same (object, grasp, finger) items in the same order, each item
    equal (the sample draw seeded by the item's index; 120 samples repeat
    clouds of fewer points), and the loader's unshuffled batches equal."""
    ours = TouchDataset(root, "recon_train", num_samples=num_samples)
    theirs = JaxTouchDataset(root, "recon_train", num_samples=num_samples)
    assert ours.items == theirs.items and len(ours) >= 6
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])
    assert ours[0]["samples"].shape == (num_samples, 3)
    batches = [list(L(ds, 2, shuffle=False)) for L, ds in ((Loader, ours), (JaxLoader, theirs))]
    assert len(batches[0]) == len(batches[1]) == len(ours) // 2
    for a, b in zip(*batches):
        _assert_items_equal(a, b)


@pytest.mark.parametrize("finger", [False, True])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_vision_dataset_validation_draws_match_jax(root, finger, eval_mode):
    """Outside training: 5 draws per object, each fixed by (object, draw),
    equal to the JAX package's, with the padded chart slots (the canonical
    finger under ``finger``) and, under ``eval_mode``, ``val_grasps``
    grasps; the loader's unshuffled batches equal."""
    kw = dict(use_img=True, use_touch=True, finger=finger, num_grasps=GRASPS,
              number_points=100, num_actions=ACTIONS, val_grasps=1, eval_mode=eval_mode)
    ours, theirs = VisionDataset(root, "valid", **kw), JaxVisionDataset(root, "valid", **kw)
    assert ours.items == theirs.items and len(ours) == 10
    counts = set()
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])
        counts.add(len(ours[i]["names"][1]))
    assert counts == {1} if eval_mode else len(counts) > 1
    charts = ours[0]["touch_charts"]
    assert charts.shape == ((GRASPS, 25, 4) if finger else (GRASPS, 4, 25, 4))
    batches = [list(L(ds, 4, shuffle=False)) for L, ds in ((Loader, ours), (JaxLoader, theirs))]
    assert len(batches[0]) == 2
    for a, b in zip(*batches):
        _assert_items_equal(a, b)


def test_vision_dataset_training_draws(root):
    """Training: one item per object; an item built from a given draw
    equals the JAX package's built from it; with a ``seed`` the draws are
    the same in two datasets whatever the loader's thread order, and differ
    between epochs; without one they come from the operating system."""
    kw = dict(number_points=100, num_grasps=GRASPS, num_actions=ACTIONS)
    ours, theirs = VisionDataset(root, "recon_train", seed=4, **kw), JaxVisionDataset(root, "recon_train", **kw)
    assert ours.items == theirs.items == [(n, 0) for n in NAMES[:3]]
    draws = [ours._grasp_draw(i) for i in range(len(ours))]
    for i, draw in enumerate(draws):
        for ds in (ours, theirs):
            ds._grasp_draw = lambda index, draw=draw: draw
        _assert_items_equal(ours[i], theirs[i])
    epochs = []
    for threads in (1, 4):
        ds = VisionDataset(root, "recon_train", seed=4, **kw)
        epochs.append([[b["names"] for b in Loader(ds, 3, shuffle=False, num_threads=threads)]
                       for _ in range(3)])
    assert epochs[0] == epochs[1]
    assert len({str(e) for e in epochs[0]}) > 1
    assert VisionDataset(root, "recon_train", **kw).seed is None


def test_trainers_run_an_epoch_from_disk(root, tmp_path):
    """``fit`` of the touch trainer over ``TouchDataset`` and of the vision
    trainer (exact loss) over ``VisionDataset`` loaders, one epoch each on
    the CPU: finite losses, and the ``best`` and ``recent`` checkpoints."""
    cfg = TouchConfig(batch_size=2, num_samples=64, epochs=1, experiments_root=str(tmp_path / "t"))
    touch = TouchEngine(cfg, device="cpu", log=False)

    def touch_loader(split, shuffle):
        ds = TouchDataset(root, split, num_samples=cfg.num_samples)
        return lambda: Loader(ds, cfg.batch_size, shuffle=shuffle)

    best = touch.fit(touch_loader("recon_train", True), touch_loader("valid", False))
    assert np.isfinite(best) and best > 0
    assert touch.ckpt.exists("best") and touch.ckpt.exists("recent")

    vcfg = VisionConfig(batch_size=2, number_points=64, num_grasps=GRASPS, num_actions=ACTIONS,
                        num_gcn_layers=2, hidden_gcn_size=16, num_cnn_blocks=3, layers_per_block=1,
                        loss_nn="exact", epochs=1, experiments_root=str(tmp_path / "v"))
    vision = VisionEngine(vcfg, device="cpu", log=False)

    def vision_loader(split, shuffle):
        ds = VisionDataset(root, split, num_grasps=GRASPS, number_points=vcfg.number_points,
                           num_actions=ACTIONS, seed=0)
        return lambda: Loader(ds, vcfg.batch_size, shuffle=shuffle)

    best = vision.fit(vision_loader("recon_train", True), vision_loader("valid", False))
    assert np.isfinite(best) and best > 0
    assert vision.ckpt.exists("best") and vision.ckpt.exists("recent")


def test_mesh_io_matches_jax(tmp_path):
    """``load_obj`` reads an OBJ with ``vt``/``vn`` lines, ``v/vt/vn`` and
    ``v//vn`` tokens and a pentagon (fan-triangulated) as the JAX package
    does; ``save_obj`` writes the same file; ``scale_points`` and
    ``add_reverse_faces`` give the same arrays."""
    src = tmp_path / "in.obj"
    src.write_text(
        "# test\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv -0.5 0.5 0.25\n"
        "vt 0 0\nvt 1 0\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/1/1\nf 1//1 3//1 4//1\nf 1 2 3 4 5\n"
    )
    ours, theirs = mesh.load_obj(str(src)), jax_mesh.load_obj(str(src))
    np.testing.assert_array_equal(ours.verts, theirs.verts)
    np.testing.assert_array_equal(ours.faces, theirs.faces)
    assert ours.faces.shape == (5, 3) and ours.verts.dtype == np.float32
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(7, 3)).astype(np.float32)
    faces = rng.integers(0, 7, size=(4, 3))
    for faces_arg in (faces, None):
        mesh.save_obj(str(tmp_path / "ours.obj"), verts, faces_arg)
        jax_mesh.save_obj(str(tmp_path / "theirs.obj"), verts, faces_arg)
        assert (tmp_path / "ours.obj").read_text() == (tmp_path / "theirs.obj").read_text()
    back = mesh.load_obj(str(tmp_path / "ours.obj"))
    np.testing.assert_allclose(back.verts, verts, atol=1e-6)
    for scale in (1.0, 2.5):
        np.testing.assert_array_equal(mesh.scale_points(verts, scale), jax_mesh.scale_points(verts, scale))
    np.testing.assert_array_equal(mesh.add_reverse_faces(faces), jax_mesh.add_reverse_faces(faces))
