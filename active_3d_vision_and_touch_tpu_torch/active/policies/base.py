"""Policy-engine base: frozen-model loading, env construction, loaders,
result persistence (the shared scaffolding of the reference's policy
engines, e.g. ``policies/baselines/even.py:18-46``)."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.active.env import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    PolicyConfig,
    VisionConfig,
    load_config,
    save_config,
)
from active_3d_vision_and_touch_tpu_torch.core.device import resolve_device
from active_3d_vision_and_touch_tpu_torch.data.datasets import ActiveDataset, Loader
from active_3d_vision_and_touch_tpu_torch.models.touch import TouchChartEncoder
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import build_autoencoder
from active_3d_vision_and_touch_tpu_torch.train.common import CheckpointManager
from active_3d_vision_and_touch_tpu_torch.train.vision import build_deformation
from active_3d_vision_and_touch_tpu_torch.utils.viz import visualize_actions

# the fields of the frozen vision model's config that define the
# reconstruction's architecture and setting
_VISION_FIELDS = (
    "use_img", "use_touch", "finger", "num_grasps", "num_gcn_layers",
    "hidden_gcn_size", "cut", "touch_global", "touch_plane", "num_cnn_blocks",
    "layers_per_block", "cnn_kernel",
)


def _load_best(model, location: str, device):
    """``model`` with the weights of the ``best`` checkpoint under
    ``location``, or as it is where there is none."""
    restored = CheckpointManager(location).restore("best", map_location=device)
    if restored is not None:
        model.load_state_dict(restored["model"])
    return model


def load_frozen_models(config: PolicyConfig, device="cuda"):
    """The frozen touch, vision (and autoencoder) models, loaded from the
    port's checkpoints under ``config.touch_location``,
    ``config.vision_location`` (and ``config.auto_location``):
    (touch_model, vision_model, auto_model), auto_model None without
    ``use_latent``.  A model without a ``best`` checkpoint keeps the weights
    drawn from its config's seed.  The vision checkpoint's config defines
    the reconstruction: its architecture and setting fields are copied into
    ``config``, so the env rebuilds the model the weights were trained
    for."""
    device = resolve_device(device)
    vision_cfg = load_config(config.vision_location, VisionConfig)
    for field in _VISION_FIELDS:
        setattr(config, field, getattr(vision_cfg, field))
    touch = init_modules_(TouchChartEncoder(), torch.Generator().manual_seed(config.seed))
    touch_model = _load_best(touch.to(device), config.touch_location, device)
    vision_model = _load_best(build_deformation(config, device), config.vision_location, device)
    auto_model = None
    if config.use_latent:
        auto_cfg = load_config(config.auto_location, AutoencoderConfig)
        auto_model = _load_best(build_autoencoder(auto_cfg, device), config.auto_location, device)
    return touch_model, vision_model, auto_model


class PolicyEngine:
    name = "policy"

    def __init__(
        self,
        config: PolicyConfig,
        data_root: str | None = None,
        env: ActiveTouchEnv | None = None,
        device=None,
    ):
        """Without ``env``, the frozen models come from their checkpoints
        and the env reads a touch signal from ``data_root``'s chart cache
        where it holds one, and grasps live through its own simulator
        (``sim/sampler.py::Sampler``) where it does not.  ``device`` is
        where the env is built and where a learned policy keeps its nets:
        by default the given env's device, else the card."""
        self.config = config
        self.data_root = data_root
        if device is None:
            device = env.device if env is not None else "cuda"
        self.device = resolve_device(device)
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        os.makedirs(config.results_dir, exist_ok=True)
        if not config.eval:
            save_config(config.checkpoint_dir, config)
        if env is None:
            env = ActiveTouchEnv(
                config, *load_frozen_models(config, self.device),
                chart_cache_root=data_root, device=self.device,
            )
        self.env = env

    def loader(self, split: str):
        ds = ActiveDataset(
            self.data_root,
            split=split,
            use_img=self.config.use_img,
            number_points=self.config.number_points,
            env_batch_size=self.config.env_batch_size,
            limit=400 if self.config.limit_data else None,
        )
        return Loader(
            ds,
            batch_size=self.config.env_batch_size,
            shuffle=split == "RL_train",
            drop_last=True,
        )

    def save_result(self, result) -> None:
        """Write the result's summary and trajectories under the results
        directory (``eval.json``, ``eval_trajectories.npz``) and, with
        ``config.visualize``, the action histogram and sphere-coverage map
        (``histogram.png``, ``sphere_projection.png``)."""
        path = os.path.join(self.config.results_dir, "eval.json")
        with open(path, "w") as f:
            json.dump(result.summary(), f, indent=2)
        np.savez(
            os.path.join(self.config.results_dir, "eval_trajectories.npz"),
            scores=result.scores,
            actions=result.actions,
        )
        if self.config.visualize:
            visualize_actions(
                self.config.results_dir,
                result.actions,
                self.config.num_actions,
                use_img=self.config.use_img,
            )
