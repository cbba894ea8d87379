"""Carry the flax models' variables over to the port's modules.

:func:`deformation_from_flax`, :func:`touch_encoder_from_flax`,
:func:`autoencoder_from_flax` and :func:`value_net_from_flax` take the flax
``params`` (and ``batch_stats``) trees as nested dicts of numpy arrays
(``jax.device_get`` of the JAX package's state), so this module never sees
JAX, and return a ``state_dict`` for :class:`models.vision.Deformation`,
:class:`models.touch.TouchChartEncoder`,
:class:`models.autoencoder.MeshAutoEncoder` and the value nets of
:mod:`models.policy_nets`.

Layouts: a Dense kernel (in, out) becomes ``Linear.weight`` (out, in); a
Conv kernel HWIO becomes OIHW; ``GCNLayer.weight`` stays (in, out); an Embed
table is an Embedding weight as it is; BatchNorm ``scale``/``bias`` and
``mean``/``var`` become ``weight``/``bias`` and
``running_mean``/``running_var``.  Every flax leaf must be consumed exactly
once: a name this mapping does not know raises, so a renamed flax module
cannot be dropped in silence.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_TOP = {
    "PositionalEncoder_0": "positional",
    "MaskEncoder_0": "mask_enc",
    "GCN_0": "gcn_1",
    "GCN_1": "gcn_2",
    "ImageEncoder_0": "global_encoder",
    "ImageEncoder_1": "local_encoder",
}
# Dense layers that flax names explicitly; the port's attributes carry the
# same names
_HEADS = ("touch_context", "plane_context", "plane_vertex")
_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _index(name: str, kind: str) -> int:
    m = re.fullmatch(rf"{kind}_(\d+)", name)
    if m is None:
        raise KeyError(f"expected {kind}_<k>, got {name!r}")
    return int(m.group(1))


def _layer(base: str, name: str, leaf: str, value: np.ndarray, kinds: dict):
    """A leaf of a flax ``Dense_k``/``Conv_k``/``BatchNorm_k`` →
    (key, array in the torch layout) under the prefix ``base``; ``kinds`` maps each
    flax layer kind the parent holds onto the port's list attribute.
    Returns None for a name it does not know."""
    kind = name.split("_")[0]
    if kind not in kinds:
        return None
    key = f"{base}{kinds[kind]}.{_index(name, kind)}"
    if kind == "BatchNorm" and leaf in _NORM_LEAVES:
        return f"{key}.{_NORM_LEAVES[leaf]}", value
    if kind == "Dense" and leaf == "kernel":
        return f"{key}.weight", value.T
    if kind == "Conv" and leaf == "kernel":
        return f"{key}.weight", value.transpose(3, 2, 0, 1)
    if kind in ("Dense", "Conv") and leaf == "bias":
        return f"{key}.bias", value
    return None


def _map_deformation(path: tuple, value: np.ndarray):
    top, *rest = path
    if top in _HEADS and rest in (["kernel"], ["bias"]):
        return (f"{top}.weight", value.T) if rest[0] == "kernel" else (f"{top}.bias", value)
    if top not in _TOP:
        raise KeyError(f"unknown flax module {top!r} in {'/'.join(path)}")
    base = _TOP[top] + "."
    if top.startswith("PositionalEncoder") and len(rest) == 2:
        return _layer(base, *rest, value, {"Dense": "layers"})
    if top.startswith("MaskEncoder") and rest == ["Embed_0", "embedding"]:
        return f"{base}embed.weight", value
    if top.startswith("GCN") and len(rest) == 2 and rest[1] in ("weight", "bias"):
        return f"{base}layers.{_index(rest[0], 'GCNLayer')}.{rest[1]}", value
    if top.startswith("ImageEncoder") and len(rest) == 2:
        return _layer(base, *rest, value, {"Conv": "convs", "BatchNorm": "norms"})
    return None


def _map_touch_encoder(path: tuple, value: np.ndarray):
    if len(path) == 2:
        return _layer("", *path, value, {"Dense": "dense"})
    if len(path) == 3:
        base = f"blocks.{_index(path[0], 'DoubleConv')}."
        return _layer(base, *path[1:], value, {"Conv": "convs", "BatchNorm": "norms"})
    return None


def _map_autoencoder(path: tuple, value: np.ndarray):
    top, *rest = path
    if top == "positional" and len(rest) == 2:
        return _layer("positional.", *rest, value, {"Dense": "layers"})
    if top == "mask_enc" and rest == ["Embed_0", "embedding"]:
        return "mask_enc.embed.weight", value
    if top == "encoder" and len(rest) == 2 and rest[0].startswith("GCNLayer"):
        if rest[1] in ("weight", "bias"):
            return f"encoder.gcn.layers.{_index(rest[0], 'GCNLayer')}.{rest[1]}", value
        return None
    if top in ("encoder", "decoder") and len(rest) == 2:
        return _layer(f"{top}.", *rest, value, {"Dense": "dense"})
    return None


def _map_value_net(path: tuple, value: np.ndarray):
    top, *rest = path
    if top == "ActionMaskEmbed_0" and len(rest) == 2:
        return _layer("mask_embed.", *rest, value, {"Dense": "dense"})
    if top == "PositionalEncoder_0" and len(rest) == 2:
        return _layer("positional.", *rest, value, {"Dense": "layers"})
    if top == "MaskEncoder_0" and rest == ["Embed_0", "embedding"]:
        return "mask_enc.embed.weight", value
    if top.startswith("GCNLayer") and len(rest) == 1 and rest[0] in ("weight", "bias"):
        return f"gcn.layers.{_index(top, 'GCNLayer')}.{rest[0]}", value
    if len(rest) == 1:
        return _layer("", top, rest[0], value, {"Dense": "dense"})
    return None


def _convert(params: dict, batch_stats: dict | None, map_leaf) -> dict:
    leaves = _flatten(params)
    leaves.update(_flatten(batch_stats or {}))
    state = {}
    for path, value in leaves.items():
        mapped = map_leaf(path, value)
        if mapped is None:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        key, arr = mapped
        if key in state:
            raise KeyError(f"two flax leaves map onto {key}")
        state[key] = torch.tensor(arr, dtype=torch.float32)
    return state


def deformation_from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """flax ``Deformation`` params (+ batch_stats) → torch ``state_dict``."""
    return _convert(params, batch_stats, _map_deformation)


def touch_encoder_from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """flax ``TouchChartEncoder`` params (+ batch_stats) → torch
    ``state_dict``.  The first Dense layer's rows need no permutation: the
    port flattens its last feature map in flax's (h, w, c) order."""
    return _convert(params, batch_stats, _map_touch_encoder)


def autoencoder_from_flax(params: dict) -> dict:
    """flax ``MeshAutoEncoder`` params → torch ``state_dict`` (the model
    has no batch statistics)."""
    return _convert(params, None, _map_autoencoder)


def value_net_from_flax(params: dict) -> dict:
    """flax ``LatentValueNet`` or ``GraphValueNet`` params → torch
    ``state_dict`` of the same net of :mod:`models.policy_nets`."""
    return _convert(params, None, _map_value_net)
