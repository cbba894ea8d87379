"""Command-line interface of the port: one binary, subcommands per engine.

The port's counterpart of the JAX package's ``cli.py``, with the same
subcommands, settings and flags (generated from the port's config
dataclasses), and ``--device`` (default ``cuda``) on every subcommand that
builds an engine::

    python -m active_3d_vision_and_touch_tpu_torch.cli generate-data --root data --objects 100
    python -m active_3d_vision_and_touch_tpu_torch.cli train-touch --root data --exp-id t0
    python -m active_3d_vision_and_touch_tpu_torch.cli train-vision --root data --setting v_t_g
    python -m active_3d_vision_and_touch_tpu_torch.cli make-touch-charts --root data --touch-location <ckpt>
    python -m active_3d_vision_and_touch_tpu_torch.cli train-auto --root data --vision-location <ckpt>
    python -m active_3d_vision_and_touch_tpu_torch.cli policy even --root data ...
    python -m active_3d_vision_and_touch_tpu_torch.cli bench

The training subcommands train across ranks when started by ``torchrun``
(one card a rank)::

    torchrun --nproc-per-node 4 -m active_3d_vision_and_touch_tpu_torch.cli train-vision --root data

Each rank then loads ``batch_size / world`` objects of every global batch
(``Loader(process_shard=(rank, world))``); ``--batch-size`` stays the
global batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    PolicyConfig,
    TouchConfig,
    VisionConfig,
)

SETTINGS = {
    "v_t_p": dict(use_img=True, finger=True),
    "v_t_g": dict(use_img=True, finger=False),
    "t_p": dict(use_img=False, finger=True),
    "t_g": dict(use_img=False, finger=False),
}


def _add_config_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in ("eval",):
            parser.add_argument("--eval", action="store_true", default=False)
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(arg, action="store_true", default=f.default, dest=f.name)
        elif isinstance(f.default, (int, float, str)):
            parser.add_argument(arg, type=type(f.default), default=f.default, dest=f.name)


def _add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default: the card)")


def _config_from_args(args, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    values = {k: v for k, v in vars(args).items() if k in names}
    cfg = cls(**values)
    if getattr(args, "setting", None):
        for k, v in SETTINGS[args.setting].items():
            setattr(cfg, k, v)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="a3vt-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate-data", help="procedural dataset generation")
    p.add_argument("--root", required=True)
    p.add_argument("--objects", type=int, default=100)
    p.add_argument("--actions", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dist-version", type=int, default=3,
                   help="procedural distribution version (4 = touch-dominant)")
    p.add_argument("--from-obj-dir", default=None,
                   help="ingest external .obj meshes instead of generating "
                        "procedural objects (reference ABC path)")

    p = sub.add_parser("train-touch")
    p.add_argument("--root", required=True)
    _add_config_args(p, TouchConfig)
    _add_device_arg(p)

    p = sub.add_parser("train-vision")
    p.add_argument("--root", required=True)
    p.add_argument("--setting", choices=sorted(SETTINGS), default=None)
    _add_config_args(p, VisionConfig)
    _add_device_arg(p)

    p = sub.add_parser("make-touch-charts")
    p.add_argument("--root", required=True)
    p.add_argument("--touch-location", required=True)
    p.add_argument("--num-actions", type=int, default=50)
    _add_device_arg(p)

    p = sub.add_parser("train-auto")
    p.add_argument("--root", required=True)
    p.add_argument("--setting", choices=sorted(SETTINGS), default=None)
    _add_config_args(p, AutoencoderConfig)
    _add_device_arg(p)

    p = sub.add_parser("policy")
    p.add_argument(
        "policy_name",
        choices=["random", "even", "greedy", "mfba", "leba", "nearest", "supervised", "ddqn"],
    )
    p.add_argument("--root", required=True)
    p.add_argument("--setting", choices=sorted(SETTINGS), default=None)
    p.add_argument("--train", action="store_true", default=False)
    _add_config_args(p, PolicyConfig)
    _add_device_arg(p)

    sub.add_parser("bench", help="run the headline benchmark")
    return parser


def _distributed(device: str):
    """(device, rank, world): joins torchrun's process group where there is
    one (``parallel.maybe_init_distributed``)."""
    import torch.distributed as dist

    from active_3d_vision_and_touch_tpu_torch.parallel import maybe_init_distributed, rank_device

    if not maybe_init_distributed(device):
        return device, 0, 1
    return rank_device(device), dist.get_rank(), dist.get_world_size()


def _fit_or_evaluate(engine, cfg, make, train_split: str) -> None:
    if cfg.eval:
        print("eval loss:", engine.evaluate(make("test", False)()))
    else:
        print("best loss:", engine.fit(make(train_split, True), make("valid", False)))


def _sharded_loader(ds, cfg, shuffle: bool, rank: int, world: int):
    """A loader of this rank's share of every global batch of
    ``cfg.batch_size``."""
    from active_3d_vision_and_touch_tpu_torch.data.datasets import Loader

    if cfg.batch_size % world:
        raise ValueError(f"batch size {cfg.batch_size} does not split over {world} ranks")
    shard = (rank, world) if world > 1 else None
    return lambda: Loader(ds, batch_size=cfg.batch_size // world, shuffle=shuffle,
                          process_shard=shard)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "generate-data":
        from active_3d_vision_and_touch_tpu_torch.data.generation import generate_dataset

        splits = generate_dataset(
            args.root, args.objects, seed=args.seed, num_actions=args.actions,
            version=args.dist_version, from_obj_dir=args.from_obj_dir,
        )
        print(json.dumps({k: len(v) for k, v in splits.items()}))
        return 0

    if args.command == "train-touch":
        from active_3d_vision_and_touch_tpu_torch.data.datasets import TouchDataset
        from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine

        device, rank, world = _distributed(args.device)
        cfg = _config_from_args(args, TouchConfig)
        engine = TouchEngine(cfg, device=device)
        limit = 3000 if cfg.limit_data else None

        def make(split, shuffle):
            ds = TouchDataset(args.root, split=split, num_samples=cfg.num_samples, limit=limit)
            return _sharded_loader(ds, cfg, shuffle, rank, world)

        _fit_or_evaluate(engine, cfg, make, "recon_train")
        return 0

    if args.command in ("train-vision", "train-auto"):
        from active_3d_vision_and_touch_tpu_torch.data.datasets import VisionDataset

        device, rank, world = _distributed(args.device)
        if args.command == "train-vision":
            from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

            cfg = _config_from_args(args, VisionConfig)
            engine, train_split, eval_mode = VisionEngine(cfg, device=device), "recon_train", cfg.eval
        else:
            from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine

            cfg = _config_from_args(args, AutoencoderConfig)
            engine, train_split, eval_mode = AutoencoderEngine(cfg, device=device), "auto_train", False

        def make(split, shuffle):
            ds = VisionDataset(
                args.root,
                split=split,
                use_img=cfg.use_img,
                use_touch=cfg.use_touch,
                finger=cfg.finger,
                num_grasps=cfg.num_grasps,
                number_points=cfg.number_points,
                eval_mode=eval_mode,
                limit=2000 if cfg.limit_data else None,
            )
            return _sharded_loader(ds, cfg, shuffle, rank, world)

        _fit_or_evaluate(engine, cfg, make, train_split)
        return 0

    if args.command == "make-touch-charts":
        from active_3d_vision_and_touch_tpu_torch.core.config import load_config
        from active_3d_vision_and_touch_tpu_torch.data.generation import make_touch_charts
        from active_3d_vision_and_touch_tpu_torch.train.common import CheckpointManager
        from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine

        cfg = load_config(args.touch_location, TouchConfig)
        cfg.eval = True
        engine = TouchEngine(cfg, device=args.device, log=False)
        restored = CheckpointManager(args.touch_location).restore("best", map_location=engine.device)
        if restored is not None:
            engine.load_state_dict(restored)
        make_touch_charts(args.root, engine, num_actions=args.num_actions)
        print("touch charts written")
        return 0

    if args.command == "policy":
        from active_3d_vision_and_touch_tpu_torch.active.policies import (
            dataset_specific,
            ddqn,
            nearest,
            simple,
            supervised,
        )

        engines = {
            "random": simple.RandomEngine,
            "even": simple.EvenEngine,
            "greedy": simple.GreedyEngine,
            "mfba": dataset_specific.MFBAEngine,
            "leba": dataset_specific.LEBAEngine,
            "nearest": nearest.NearestNeighborEngine,
            "supervised": supervised.SupervisedEngine,
            "ddqn": ddqn.DDQNEngine,
        }
        cfg = _config_from_args(args, PolicyConfig)
        engine = engines[args.policy_name](cfg, data_root=args.root, device=args.device)
        if args.train and hasattr(engine, "train"):
            engine.train()
        if args.train and hasattr(engine, "train_epoch"):
            for _ in range(cfg.epochs):
                print(engine.train_epoch())
        result = engine.evaluate(split="test" if cfg.eval else "valid")
        print(json.dumps(result.summary()))
        return 0

    if args.command == "bench":
        from active_3d_vision_and_touch_tpu_torch import bench

        bench.main()
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
