"""Seeded weights on the device: one uniform draw from a ``torch.Generator``
on the card for the whole model, cut into leaves and scaled by kind.

The last GCN layer of each stack (the vertex update) is drawn at 1/20 of
the published init.  At the published init it moves the whole mesh by
0.17 to 0.34 (the atlas's radius is 0.25), by an amount that depends on
the seed, and with it the share of vertices that project into the image
(18% to 46%), which sets the work of the image sampling and of its
backward.  At 1/20 the mesh stays on the object, as it does in training
past its first steps, and 66% to 71% of the vertices project into the
image on every seed."""

from __future__ import annotations

import math

import torch

# half-width of each kind's uniform draw, from its fan-in; BatchNorm
# statistics and scales sit about their neutral values
SCALES = {
    "dense": lambda fan_in: math.sqrt(3.0 / fan_in),  # variance 1 / fan_in
    "conv": lambda fan_in: math.sqrt(6.0 / fan_in),  # variance 2 / fan_in, before a ReLU
    "gcn": lambda fan_in: 1.8 / math.sqrt(fan_in + 1),  # the published GCN init
    "gcn_bias": lambda fan_in: 0.1,
    "gcn_out": lambda fan_in: 0.05 * 1.8 / math.sqrt(fan_in + 1),
    "gcn_out_bias": lambda fan_in: 0.05 * 0.1,
    "bias": lambda fan_in: 0.05,
    "embed": lambda fan_in: math.sqrt(3.0) * 0.5,
    "bn_weight": lambda fan_in: 0.1,
    "bn_bias": lambda fan_in: 0.1,
    "bn_mean": lambda fan_in: 0.05,
    "bn_var": lambda fan_in: 0.2,
}
CENTRES = {"bn_weight": 1.0, "bn_var": 1.0}


def seeded_weights(specs: list, seed: int, device) -> dict:
    """``specs`` as (name, shape, kind, fan_in) → {name: float32 tensor}."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2).sub_(1)
    out, offset = {}, 0
    for (name, shape, kind, fan_in), size in zip(specs, sizes):
        leaf = flat[offset:offset + size].view(shape)
        out[name] = leaf * SCALES[kind](fan_in) + CENTRES.get(kind, 0.0)
        offset += size
    return out


def module_specs(module) -> list:
    """(name, shape, kind, fan_in) of every float leaf of ``module``'s
    state: GCN layers (weights stored (in, out)) by the published GCN init,
    ``nn.Linear`` weights (out, in) by their fan-in, embeddings, biases."""
    specs = []
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        shape = tuple(t.shape)
        if ".gcn.layers." in f".{name}":
            kind, fan_in = ("gcn", shape[0]) if len(shape) == 2 else ("gcn_bias", 1)
        elif name.endswith("embed.weight"):
            kind, fan_in = "embed", shape[0]
        elif len(shape) == 2:
            kind, fan_in = "dense", shape[1]
        else:
            kind, fan_in = "bias", 1
        specs.append((name, shape, kind, fan_in))
    return specs
