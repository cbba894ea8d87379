"""Experiment configuration: typed dataclasses with a JSON round-trip.

The port's own copy of the JAX package's ``core/config.py`` (the port
imports nothing of that package).  Defaults are identical, including
``loss_nn="clustered"``, so a config file written by either package
rebuilds the same experiment in the other; ``load_config`` drops the
fields the port does not have (``PolicyConfig.result_tag``).  One default
differs on purpose:
``AutoencoderConfig.loss_nn`` is ``"exact"``, because the clustered loss
passes no gradient to the cloud the autoencoder decodes (see
``train/autoencoder.py``).  The settings keep their
reference names: ``v_t_p`` / ``v_t_g`` (vision+touch, single-finger /
4-finger grasp) and ``t_p`` / ``t_g`` (touch-only).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field


def setting_name(use_img: bool, finger: bool) -> str:
    return ("v_t_" if use_img else "t_") + ("p" if finger else "g")


def save_config(directory: str, config) -> str:
    os.makedirs(directory, exist_ok=True)
    payload = dataclasses.asdict(config)
    payload["__class__"] = type(config).__name__
    payload["check_point"] = os.path.abspath(directory)
    path = os.path.join(directory, "config.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def load_config(directory: str, cls):
    """Rebuild a config dataclass from ``<directory>/config.json``."""
    with open(os.path.join(directory, "config.json")) as f:
        payload = json.load(f)
    payload.pop("__class__", None)
    payload.pop("check_point", None)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in payload.items() if k in names})


@dataclass
class BaseConfig:
    exp_id: str = "test"
    exp_type: str = "test"
    seed: int = 0
    lr: float = 3e-4
    batch_size: int = 16
    epochs: int = 1000
    patience: int = 70
    loss_coeff: float = 9000.0
    limit_data: bool = False
    eval: bool = False
    pretrained: bool = False
    visualize: bool = False
    # NN search for training losses: "clustered" (Morton-pruned kernel),
    # "exact" (brute-force kernel; scoring always uses this) or "xla" (the
    # chunked plain brute force, benchmark baseline)
    loss_nn: str = "clustered"
    experiments_root: str = "experiments"

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(
            self.experiments_root, "checkpoint", self.exp_type, self.exp_id
        )

    @property
    def results_dir(self) -> str:
        return os.path.join("results", self.exp_type, self.exp_id)

    @property
    def tensorboard_dir(self) -> str:
        return os.path.join(self.experiments_root, "tensorboard", self.exp_type)


@dataclass
class TouchConfig(BaseConfig):
    """Touch-chart trainer defaults (reference ``touch/train.py:203-255``)."""

    lr: float = 1e-4
    batch_size: int = 64
    num_samples: int = 4000  # CD sample count
    # touch charts are tiny (25-vertex sheets, 4k-point clouds): the exact
    # scan is the JAX package's choice at this size
    loss_nn: str = "exact"


@dataclass
class VisionConfig(BaseConfig):
    """Vision deformation trainer defaults (``vision/train.py:287-405``)."""

    use_img: bool = True
    use_touch: bool = True
    finger: bool = False
    num_grasps: int = 5
    num_actions: int = 50
    number_points: int = 30000
    val_grasps: int = -1
    num_gcn_layers: int = 20
    hidden_gcn_size: int = 300
    cut: float = 0.33
    # global touch-context and per-contact plane pathways of the model
    # (models/vision.py::Deformation); off by default
    touch_global: bool = False
    touch_plane: bool = False
    num_cnn_blocks: int = 6
    layers_per_block: int = 3
    cnn_kernel: int = 5

    @property
    def num_fingers(self) -> int:
        return 1 if self.finger else 4

    @property
    def setting(self) -> str:
        return setting_name(self.use_img, self.finger)


@dataclass
class AutoencoderConfig(VisionConfig):
    """Autoencoder trainer defaults (``autoencoder/train.py:349-452``).

    ``loss_nn`` is ``"exact"``, where the JAX package inherits
    ``"clustered"``: the decoded cloud is the second argument of the
    Chamfer loss, and the clustered loss treats that argument as data."""

    encoding_size: int = 200
    grid_size: int = 80
    vision_location: str = ""
    loss_nn: str = "exact"


@dataclass
class PolicyConfig(VisionConfig):
    """Defaults of the active policies (reference ``policies/*/train.py``
    arg blocks), the learned ones' included."""

    env_batch_size: int = 3
    budget: int = 5
    num_grasps: int = 5
    use_latent: bool = False
    use_recon: bool = False
    touch_location: str = ""
    vision_location: str = ""
    auto_location: str = ""
    # the value nets take the reference's per-setting sizes (ddqn.py)
    pretrained_recon: bool = True
    greedy_checks: int = 50
    # DDQN (reference DDQN/train.py:400-527)
    epsilon_start: float = 1.0
    epsilon_decay: float = 0.9999
    epsilon_end: float = 0.01
    mem_capacity: int = 300
    burn_in: int = 20
    train_batch_size: int = 16
    gamma: float = 0.0
    target_update: int = 3000
    normalization: str = "first"
    hidden_dim: int = 300
    layers: int = 5
    normalize: bool = False
    epochs: int = 1000
    # the supervised policy: probe actions per step, the selection rule
    # ("argmin" as the reference, which regresses an improvement and picks
    # its least; "argmax" picks the greatest), and epochs per step (more
    # than 1 selects each step's model by a validation rollout)
    training_actions: int = 5
    supervised_select: str = "argmin"
    supervised_epochs: int = 1


@dataclass
class SimConfig:
    """Host simulator parameters."""

    max_depth: float = 0.025
    touch_resolution: int = 121
    vision_resolution: int = 256
    object_colour: tuple = (228, 217, 111, 255)
    num_fingers: int = 4
    tacto: bool = False
    workers: int = field(default_factory=lambda: min(8, os.cpu_count() or 1))
