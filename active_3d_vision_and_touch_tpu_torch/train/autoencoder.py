"""Mesh-autoencoder trainer.

Port of the JAX package's ``train/autoencoder.py``.  The autoencoder learns
to embed the frozen vision model's predictions: each batch runs the
deformation (eval mode, no graph), the autoencoder encodes the deformed
mesh to a latent and folds a point cloud back out, and the loss is
loss_coeff * CD(deformed-mesh samples, decoded points).  Gradients reach
only the autoencoder.

The Chamfer loss takes the decoded cloud as its second argument.  The
clustered loss passes no gradient to that argument (it is the gt cloud in
every other caller), so ``loss_nn="clustered"`` would train nothing: the
engine refuses it, and :class:`core.config.AutoencoderConfig` defaults to
``"exact"``.

Spans (``utils/profiler.py``, recorded under a profiler): ``auto.deform``,
the frozen deformation's forward (in ``_loss``, so under
``recon.forward_loss`` or ``recon.eval_step``, and in
``collect_latents``); ``auto.encode``, the positional and mask features,
the GCN encoder, the vertex max-pool and the MLP to the latent;
``auto.decode``, the FoldingNet decoder; ``auto.chamfer``, the sampler on
the frozen mesh and the Chamfer distance; the last three in ``_loss``.
None runs in a step replayed from its CUDA graph (``train/base.py``).
Counter ``auto.clouds``: the clouds decoded, B a loss (and each replay
adds its capture's count).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    VisionConfig,
    load_config,
)
from active_3d_vision_and_touch_tpu_torch.core.device import resolve_device
from active_3d_vision_and_touch_tpu_torch.models.autoencoder import MeshAutoEncoder
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import mesh_chamfer_distance
from active_3d_vision_and_touch_tpu_torch.train.base import ReconEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from active_3d_vision_and_touch_tpu_torch.utils.profiler import count, span
from active_3d_vision_and_touch_tpu_torch.utils.viz import write_png


def build_autoencoder(config, device="cuda") -> MeshAutoEncoder:
    """The autoencoder of ``config`` (an ``AutoencoderConfig``) on
    ``device``, its weights drawn on the CPU from ``config.seed``."""
    model = MeshAutoEncoder(
        encoding_size=config.encoding_size,
        num_gcn_layers=config.num_gcn_layers,
        hidden_gcn_size=config.hidden_gcn_size,
        cut=config.cut,
        grid_size=config.grid_size,
    )
    init_modules_(model, torch.Generator().manual_seed(config.seed))
    return model.to(resolve_device(device))


class AutoencoderEngine(ReconEngine):
    loss_tag = "auto_cd"

    def __init__(
        self,
        config: AutoencoderConfig | None = None,
        vision_engine: VisionEngine | None = None,
        vision_state: dict | None = None,
        device="cuda",
        log: bool = True,
    ):
        """``vision_engine`` is the frozen deformation model's engine, rebuilt
        from ``config.vision_location`` when not given; ``vision_state`` a
        ``state_dict`` for its model, else the engine's ``best`` checkpoint
        where there is one, else the engine's weights as they are.  A given
        engine becomes the autoencoder's: its model is frozen here (eval
        mode, running BatchNorm statistics, no gradient) and stays so, so
        pass one that is no longer being trained."""
        config = config or AutoencoderConfig()
        if config.loss_nn == "clustered":
            raise ValueError(
                "AutoencoderEngine: loss_nn='clustered' trains nothing: the clustered "
                "Chamfer loss passes no gradient to its second argument, which here is "
                "the decoded cloud; use 'exact' (the default) or 'xla'"
            )
        device = resolve_device(device)
        if vision_engine is None:
            vision_config = load_config(config.vision_location, VisionConfig)
            vision_config.eval = True
            vision_engine = VisionEngine(vision_config, device=device, log=False)
        self.vision = vision_engine
        if vision_state is None:
            restored = self.vision.ckpt.restore("best", map_location=device)
            vision_state = None if restored is None else restored["model"]
        if vision_state is not None:
            self.vision.model.load_state_dict(vision_state)
        self.vision.model.eval().requires_grad_(False)

        self.model = build_autoencoder(config, device)
        self.adj = self.vision.adj
        self.faces = self.vision.faces
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.lr)
        super().__init__(config, device=device, log=log)

    @torch.no_grad()
    def deform(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen deformation's (verts, mask) of ``batch``."""
        with span("auto.deform"):
            return self.vision.forward(batch)

    def _loss(self, batch: dict, generator, draws) -> torch.Tensor:
        verts, mask = self.deform(batch)
        with span("auto.encode"):
            latent = self.model.encode(verts, mask, self.adj)
        count("auto.clouds", verts.shape[0])
        with span("auto.decode"):
            pred_points = self.model.decoder(latent)
        with span("auto.chamfer"):
            cd = mesh_chamfer_distance(
                verts,
                self.faces,
                pred_points,
                generator,
                num=self.config.number_points,
                nn=self.config.loss_nn,
                draws=draws,
                shard=self.shard,
            )
        return self.config.loss_coeff * cd.mean()

    def encode(self, verts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Frozen latent extraction for the active policies."""
        self.model.eval()
        with torch.no_grad():
            return self.model(verts, mask, self.adj, only_encode=True)

    def collect_latents(self, loader) -> tuple[np.ndarray, list]:
        """(latents (N, E), names) over a loader of vision batches."""
        if not self.built:
            self.build()
        latents, names = [], []
        for batch in loader:
            verts, mask = self.deform(self.to_device(batch))
            latents.append(self.encode(verts, mask).cpu().numpy())
            names += list(batch.get("names", range(len(verts))))
        return np.concatenate(latents, axis=0), names

    def cluster(
        self,
        loader,
        image_dir: str,
        out_dir: str,
        examples: int = 20,
        neighbors: int = 4,
        seed: int = 0,
    ) -> list[str]:
        """Latent-space nearest-neighbour collages: for random anchors, tile
        the images of their closest distinct latents (the reference's
        qualitative AE eval, ``autoencoder/train.py:316-346``)."""
        latents, names = self.collect_latents(loader)
        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.default_rng(seed)
        anchors = rng.choice(len(latents), size=min(examples, len(latents)))
        paths = []
        for v, anchor in enumerate(anchors):
            d = ((latents - latents[anchor]) ** 2).sum(-1)
            seen, row = [], []
            for idx in np.argsort(d):
                obj = str(names[idx][0] if isinstance(names[idx], tuple) else names[idx])
                obj = obj.split("/")[-1]
                if obj in seen:
                    continue
                seen.append(obj)
                row.append(os.path.join(image_dir, obj + ".npy"))
                if len(row) == neighbors + 1:
                    break
            collage = np.concatenate([np.load(p).astype(np.uint8) for p in row], axis=1)
            path = os.path.join(out_dir, f"valid_{v}.png")
            write_png(path, collage)
            paths.append(path)
        return paths
