"""Vision deformation trainer.

Port of the JAX package's ``train/vision.py``.  Batches: ``img``
(B, 256, 256, 3) NHWC [when use_img], ``gt_points`` (B, number_points, 3),
``touch_charts`` (B, num_grasps, [num_fingers,] 25, 4) [when use_touch].
Loss: loss_coeff * mean over the batch of the 3-repeat Chamfer distance
between the deformed mesh, sampled at number_points, and gt_points.
"""

from __future__ import annotations

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.core import build_adj_info, vision_charts
from active_3d_vision_and_touch_tpu_torch.core.config import VisionConfig
from active_3d_vision_and_touch_tpu_torch.core.device import resolve_device
from active_3d_vision_and_touch_tpu_torch.models.vision import (
    Deformation,
    init_modules_,
    prepare_charts,
)
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import mesh_chamfer_distance
from active_3d_vision_and_touch_tpu_torch.train.base import ReconEngine
from active_3d_vision_and_touch_tpu_torch.utils.viz import visualize_prediction


def deformation_geometry(config: VisionConfig, device="cuda"):
    """(adj_info, initial_mesh) on ``device``: the adjacency of the atlas
    with ``config``'s grasp slots, and the atlas's initial vertices."""
    device = resolve_device(device)
    atlas = vision_charts()
    adj_info = build_adj_info(
        atlas,
        use_touch=config.use_touch,
        num_fingers=config.num_fingers,
        num_grasps=config.num_grasps,
    )
    return adj_info.to(device), torch.as_tensor(atlas.verts, device=device)


def build_deformation(config: VisionConfig, device="cuda") -> Deformation:
    """The ``Deformation`` of ``config`` on ``device``.  The weights are
    drawn on the CPU from a generator seeded with ``config.seed``, so every
    device starts from the same ones."""
    model = Deformation(
        use_img=config.use_img,
        use_touch=config.use_touch,
        touch_global=config.touch_global,
        touch_plane=config.touch_plane,
        num_gcn_layers=config.num_gcn_layers,
        hidden_gcn_size=config.hidden_gcn_size,
        cut=config.cut,
        num_cnn_blocks=config.num_cnn_blocks,
        layers_per_block=config.layers_per_block,
        cnn_kernel=config.cnn_kernel,
    )
    init_modules_(model, torch.Generator().manual_seed(config.seed))
    return model.to(resolve_device(device))


class VisionEngine(ReconEngine):
    loss_tag = "vision_cd"

    def __init__(self, config: VisionConfig | None = None, device="cuda", log: bool = True):
        config = config or VisionConfig()
        self.model = build_deformation(config, device)
        self.adj_info, self.initial_mesh = deformation_geometry(config, device)
        self.adj = self.adj_info.adj
        self.original_adj = self.adj_info.original
        self.faces = self.adj_info.faces
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.lr)
        super().__init__(config, device=device, log=log)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The deformed mesh of ``batch``: (verts (B, V, 3), mask (B, V, 1)),
        in the model's current mode."""
        b = batch["gt_points"].shape[0]
        charts = prepare_charts(
            batch.get("touch_charts"), self.initial_mesh, b, use_touch=self.config.use_touch
        )
        return self.model(batch.get("img"), charts, self.adj, self.original_adj)

    def _loss(self, batch: dict, generator, draws) -> torch.Tensor:
        verts, _ = self.forward(batch)
        cd = mesh_chamfer_distance(
            verts,
            self.faces,
            batch["gt_points"],
            generator,
            num=self.config.number_points,
            nn=self.config.loss_nn,
            draws=draws,
            shard=self.shard,
        )
        return self.config.loss_coeff * cd.mean()

    def evaluate_detailed(self, loader, visualize_dir: str | None = None,
                          max_visualize: int = 8) -> tuple[float, list[dict]]:
        """Per-object Chamfer distance over a loader, the exact search (K1
        on the card) at ``number_points``, and with ``visualize_dir`` the
        first ``max_visualize`` predictions rendered beside their gt clouds
        (the reference's eval + --visualize path, ``vision/train.py:159-208``).
        Batch i draws from ``step_generator(i)``.  Returns (mean_cd,
        [{"name", "cd"}, ...]), names from ``batch["names"][j][0]``."""
        if not self.built:
            self.build()
        self.model.eval()
        per_object, rendered = [], 0
        for i, batch in enumerate(loader):
            names = batch.get("names", None)
            arrays = self.to_device(batch)
            with torch.no_grad():
                verts, _ = self.forward(arrays)
                cds = self.config.loss_coeff * mesh_chamfer_distance(
                    verts, self.faces, arrays["gt_points"], self.step_generator(i),
                    num=self.config.number_points,
                )
            cds = cds.cpu().numpy()
            for j, cd in enumerate(cds):
                per_object.append({"name": str(names[j][0]) if names else str(j), "cd": float(cd)})
            if visualize_dir and rendered < max_visualize:
                take = min(len(cds), max_visualize - rendered)
                visualize_prediction(
                    visualize_dir,
                    verts[:take].cpu().numpy(),
                    self.faces.cpu().numpy(),
                    [p["name"] for p in per_object[-len(cds):][:take]],
                    gt_points=arrays["gt_points"][:take].cpu().numpy(),
                )
                rendered += take
        mean_cd = float(np.mean([p["cd"] for p in per_object])) if per_object else float("nan")
        return mean_cd, per_object
