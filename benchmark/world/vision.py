"""A seeded world in the dataset layout the port reads: per object a
256x256 RGB image (``images_colourful/<name>.npy``), a surface-like gt
cloud (``point_cloud_info/<name>.npy``), a chart cache of every grasp
(``touch_charts/<name>/touch_charts.npy``) and the mesh the cloud was
sampled from (``object_info/<name>_verts.npy``, ``_faces.npy``, which the
env's simulator loads at each reset), and ``data_split.npy``.  Meshes,
clouds and images are made on the device from the seed; the chart caches
in a few numpy calls."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.atlas import vision_sphere


def bent_spheres(b: int, gen: torch.Generator, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, 1536, 3) vertices and (1728, 3) faces: the vision atlas (a sphere
    of radius 0.25), scaled per axis by 0.6-1.4 and bent by a low-frequency
    displacement."""
    verts, faces = vision_sphere()
    v = torch.as_tensor(verts, device=dev)[None].expand(b, -1, -1)
    v = v * (0.6 + 0.8 * torch.rand(b, 1, 3, device=dev, generator=gen))
    phase = 6.28 * torch.rand(b, 1, 3, device=dev, generator=gen)
    return v + 0.03 * torch.sin(9.0 * v.roll(1, dims=-1) + phase), torch.as_tensor(faces, device=dev)


def surface_clouds(verts: torch.Tensor, faces: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """(b, n, 3) area-weighted samples of the meshes (b, V, 3) over ``faces``:
    surfaces, on which the pruned search is meant to run."""
    b, dev = verts.shape[0], verts.device
    c = verts[:, faces]  # (b, F, 3, 3)
    area = torch.linalg.vector_norm(torch.linalg.cross(c[:, :, 1] - c[:, :, 0], c[:, :, 2] - c[:, :, 0]), dim=-1)
    idx = torch.multinomial(area, n, replacement=True, generator=gen)
    pick = torch.gather(c, 1, idx[..., None, None].expand(-1, -1, 3, 3))
    u = torch.rand(b, n, 1, device=dev, generator=gen).sqrt()
    w = torch.rand(b, n, 1, device=dev, generator=gen)
    return (1 - u) * pick[:, :, 0] + u * (1 - w) * pick[:, :, 1] + u * w * pick[:, :, 2]


def chart_caches(clouds: np.ndarray, num_actions: int, rng: np.random.Generator) -> np.ndarray:
    """(objects, actions, 4 fingers, 25, xyz | code): in every grasp two
    fingers touch (a small sheet about a point of the cloud, code 2), one
    does not (collapsed onto its position, code 1) and one fails (code 0)."""
    n, p = clouds.shape[:2]
    codes = rng.permuted(np.tile(np.array([0, 1, 2, 2], np.float32), (n, num_actions, 1)), axis=2)
    at = rng.integers(p, size=(n, num_actions, 4))
    pos = clouds[np.arange(n)[:, None, None], at]  # (n, A, 4, 3)
    sheet = pos[:, :, :, None, :] + rng.normal(size=(n, num_actions, 4, 25, 3)) * 0.003
    xyz = np.where(codes[..., None, None] == 2, sheet,
                   np.where(codes[..., None, None] == 1, pos[:, :, :, None, :], 0.0))
    out = np.empty((n, num_actions, 4, 25, 4), np.float32)
    out[..., :3] = xyz
    out[..., 3] = codes[..., None]
    return out


def split_sizes(spec) -> tuple[int, int]:
    """(names, distinct objects) of a split's entry in a traffic mix: a
    count of distinct objects, or {"names": n, "distinct": d}, n names whose
    files link to d distinct objects in turn."""
    if isinstance(spec, int):
        return spec, spec
    return spec["names"], spec["distinct"]


def write_vision_world(root: Path, seed: int, dev, splits: dict, cloud_points: int,
                       num_actions: int, image_size: int = 256) -> dict:
    """Writes ``splits`` ({split: entry}, see :func:`split_sizes`) under
    ``root`` (emptied first) and returns {split: names}."""
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: root / k for k in ("images_colourful", "point_cloud_info", "touch_charts", "object_info")}
    for d in dirs.values():
        d.mkdir(parents=True)
    sizes = {s: split_sizes(e) for s, e in splits.items()}
    names = {s: [f"{s}_{i:04d}" for i in range(n)] for s, (n, _) in sizes.items()}
    flat = [n for s, (_, d) in sizes.items() for n in names[s][:d]]
    gen = torch.Generator(device=dev).manual_seed(seed)
    verts, faces = bent_spheres(len(flat), gen, dev)
    clouds = surface_clouds(verts, faces, cloud_points, gen).cpu().numpy()
    verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
    images = torch.randint(0, 256, (len(flat), image_size, image_size, 3), generator=gen,
                           device=dev, dtype=torch.uint8).cpu().numpy()
    charts = chart_caches(clouds, num_actions, np.random.default_rng(seed))
    for i, name in enumerate(flat):
        np.save(dirs["images_colourful"] / f"{name}.npy", images[i])
        np.save(dirs["point_cloud_info"] / f"{name}.npy", clouds[i])
        (dirs["touch_charts"] / name).mkdir()
        np.save(dirs["touch_charts"] / name / "touch_charts.npy", charts[i])
        np.save(dirs["object_info"] / f"{name}_verts.npy", verts[i])
        np.save(dirs["object_info"] / f"{name}_faces.npy", faces)
    for s, (n, d) in sizes.items():
        for i in range(d, n):
            name, target = names[s][i], names[s][i % d]
            for kind in ("images_colourful", "point_cloud_info"):
                (dirs[kind] / f"{name}.npy").symlink_to(f"{target}.npy")
            (dirs["touch_charts"] / name).symlink_to(target)
            for part in ("verts", "faces"):
                (dirs["object_info"] / f"{name}_{part}.npy").symlink_to(f"{target}_{part}.npy")
    np.save(root / "data_split.npy", names)
    return names
