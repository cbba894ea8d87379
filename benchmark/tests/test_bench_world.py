"""The seeded world: the layout the port's datasets read, the same world
from the same seed, and the chart caches' codes."""

import numpy as np
import torch

from benchmark.world.vision import bent_spheres, chart_caches, surface_clouds, write_vision_world


def test_chart_caches_hold_every_code_in_every_grasp():
    clouds = np.random.default_rng(0).normal(size=(3, 100, 3)).astype(np.float32)
    charts = chart_caches(clouds, 7, np.random.default_rng(1))
    assert charts.shape == (3, 7, 4, 25, 4)
    codes = charts[..., 0, 3]
    assert (np.sort(codes, axis=-1) == [0, 1, 2, 2]).all()
    assert (charts[..., 3] == codes[..., None]).all()
    assert (charts[codes == 0][..., :3] == 0).all()
    collapsed = charts[codes == 1][..., :3]
    assert (collapsed == collapsed[:, :1]).all()


def test_surface_clouds_lie_near_the_bent_sphere():
    gen = torch.Generator().manual_seed(3)
    clouds = surface_clouds(*bent_spheres(2, gen, torch.device("cpu")), 500, gen)
    r = torch.linalg.vector_norm(clouds, dim=-1)
    assert clouds.shape == (2, 500, 3) and 0.1 < float(r.min()) and float(r.max()) < 0.4


def test_world_is_read_by_the_port_and_repeats_from_its_seed(tmp_path):
    from active_3d_vision_and_touch_tpu_torch.data.datasets import VisionDataset

    dev = torch.device("cpu")
    names = write_vision_world(tmp_path / "a", 5, dev, {"recon_train": 3, "valid": 2}, 300, 6, 32)
    write_vision_world(tmp_path / "b", 5, dev, {"recon_train": 3, "valid": 2}, 300, 6, 32)
    assert names["valid"] == ["valid_0000", "valid_0001"]
    for kind in ("images_colourful", "point_cloud_info"):
        a = np.load(tmp_path / "a" / kind / "recon_train_0001.npy")
        assert (a == np.load(tmp_path / "b" / kind / "recon_train_0001.npy")).all()
    ds = VisionDataset(str(tmp_path / "a"), "valid", number_points=200, num_actions=6, seed=1)
    item = ds[0]
    assert len(ds) == 10 and item["gt_points"].shape == (200, 3) and item["img"].shape == (32, 32, 3)
    assert item["touch_charts"].shape == (5, 4, 25, 4)
    verts = np.load(tmp_path / "a" / "object_info" / "valid_0001_verts.npy")
    faces = np.load(tmp_path / "a" / "object_info" / "valid_0001_faces.npy")
    assert verts.shape == (1536, 3) and faces.shape == (1728, 3) and faces.max() == 1535


def test_names_beyond_the_distinct_objects_link_to_them_in_turn(tmp_path):
    dev = torch.device("cpu")
    names = write_vision_world(tmp_path, 2, dev, {"recon_train": {"names": 5, "distinct": 2}}, 300, 6, 32)
    assert names["recon_train"] == [f"recon_train_{i:04d}" for i in range(5)]
    for i in range(5):
        for kind, suffix in (("images_colourful", ".npy"), ("object_info", "_verts.npy")):
            got = np.load(tmp_path / kind / f"recon_train_{i:04d}{suffix}")
            assert (got == np.load(tmp_path / kind / f"recon_train_{i % 2:04d}{suffix}")).all()
        charts = np.load(tmp_path / "touch_charts" / f"recon_train_{i:04d}" / "touch_charts.npy")
        assert charts.shape == (6, 4, 25, 4)
