"""A seeded world in the layout the port's ``TouchDataset`` reads: per object
and grasp, per finger, a 121x121 uint8 gel image
(``grasp_info/<name>/<grasp>/<finger>_touch.npy``), the local touch cloud
(``_points.npy``) and the fingertip frame (``_ref_frame.npy``, a pickled
dict of ``pos`` (3,) and ``rot`` (3, 3))), and ``data_split.npy``.  The
object list is read from ``images_colourful/`` and ``point_cloud_info/``,
which hold a placeholder a name here: the touch dataset reads no image and
no object cloud.

A touch cloud is a curved patch the size of the sensor's chart (about
±0.01) about the fingertip, in its frame, moved into the world by the
frame; gel images are noise.  Everything is drawn on the device from the
seed."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from benchmark.world.vision import split_sizes

IMAGE_SIZE = 121  # the encoder's flatten fixes the gel image's size


def rotations(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """(n, 3, 3) proper rotations, Q of the QR of a normal draw with the
    signs of R's diagonal taken out."""
    q, r = torch.linalg.qr(torch.randn(n, 3, 3, generator=gen, device=dev))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    return q * torch.sign(torch.linalg.det(q))[:, None, None]


def touch_patches(n: int, points: int, gen: torch.Generator, dev) -> tuple:
    """(clouds (n, points, 3) in the world, pos (n, 3), rot (n, 3, 3)): each
    a patch z = a x² + b y² over x, y in ±0.01 of the fingertip's frame,
    which sits 0.08-0.16 from the origin."""
    xy = (torch.rand(n, points, 2, generator=gen, device=dev) * 2 - 1) * 0.01
    curve = (torch.rand(n, 1, 2, generator=gen, device=dev) * 2 - 1) * 20.0
    local = torch.cat([xy, (curve * xy.square()).sum(-1, keepdim=True)], dim=-1)
    rot = rotations(n, gen, dev)
    direction = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen, device=dev), dim=-1)
    pos = direction * (0.08 + 0.08 * torch.rand(n, 1, generator=gen, device=dev))
    return torch.einsum("nij,npj->npi", rot, local) + pos[:, None], pos, rot


def write_touch_world(root: Path, seed: int, dev, splits: dict, grasps: int, fingers: int,
                      cloud_points: int) -> dict:
    """Writes ``splits`` ({split: entry}, see ``world/vision.py::split_sizes``)
    of ``grasps`` x ``fingers`` touches an object under ``root`` (emptied
    first) and returns {split: names}."""
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: root / k for k in ("images_colourful", "point_cloud_info", "grasp_info")}
    for d in dirs.values():
        d.mkdir(parents=True)
    sizes = {s: split_sizes(e) for s, e in splits.items()}
    names = {s: [f"{s}_{i:04d}" for i in range(n)] for s, (n, _) in sizes.items()}
    flat = [n for s, (_, d) in sizes.items() for n in names[s][:d]]
    touches = len(flat) * grasps * fingers
    gen = torch.Generator(device=dev).manual_seed(seed)
    clouds, pos, rot = touch_patches(touches, cloud_points, gen, dev)
    images = torch.randint(0, 256, (touches, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    clouds, pos, rot, images = (t.cpu().numpy() for t in (clouds, pos, rot, images))
    placeholder = np.zeros((1, 3), np.float32)
    i = 0
    for name in flat:
        np.save(dirs["images_colourful"] / f"{name}.npy", placeholder)
        np.save(dirs["point_cloud_info"] / f"{name}.npy", placeholder)
        for g in range(grasps):
            gdir = dirs["grasp_info"] / name / str(g)
            gdir.mkdir(parents=True)
            for f in range(fingers):
                np.save(gdir / f"{f}_touch.npy", images[i])
                np.save(gdir / f"{f}_points.npy", clouds[i])
                np.save(gdir / f"{f}_ref_frame.npy", {"pos": pos[i], "rot": rot[i]})
                i += 1
    for s, (n, d) in sizes.items():
        for k in range(d, n):
            name, target = names[s][k], names[s][k % d]
            for kind in ("images_colourful", "point_cloud_info"):
                (dirs[kind] / f"{name}.npy").symlink_to(f"{target}.npy")
            (dirs["grasp_info"] / name).symlink_to(target)
    np.save(root / "data_split.npy", names)
    return names
