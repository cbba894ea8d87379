"""Graph convolution over dense chart-atlas adjacencies.

Port of the JAX package's ``models/gcn.py``.  The adjacency is a dense
(V, V) row-stochastic matrix (V = 2036 at v_t_g), so a layer is two matrix
products: features @ weight, then adjacency @ (first ``cut`` share of the
features).  Parameters keep the flax layouts: ``GCNLayer.weight`` is
(in, out), as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from active_3d_vision_and_touch_tpu_torch.ops.encoding import nerf_embedding


class _Bf16Matmul(torch.autograd.Function):
    """2-D ``a @ b`` on bf16-rounded operands with a float32 result.

    ``torch.mm(..., out_dtype=torch.float32)`` runs the bf16 tensor-core
    product with float32 accumulation and writes the float32 sum without
    rounding it to bf16.  The backward products take the incoming gradient
    rounded to bf16 the same way."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return torch.mm(a16, b16, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        ga = torch.mm(g16, b16.T, out_dtype=torch.float32)
        gb = torch.mm(a16.T, g16, out_dtype=torch.float32)
        return ga, gb


def _folded_matmul(a: torch.Tensor, b: torch.Tensor, mm) -> torch.Tensor:
    """(..., K) @ (K, N) or (V, V) @ (B, V, N) as one 2-D product ``mm``."""
    if b.dim() == 2:
        out = mm(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    # (V, V) @ (B, V, N) as one (V, V) @ (V, B*N) product
    bsz, v, n = b.shape
    out = mm(a, b.transpose(0, 1).reshape(v, bsz * n))
    return out.reshape(v, bsz, n).transpose(0, 1)


def _mxu_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The GCN's two products, as the JAX package runs them: float32 on the
    CPU; bf16 operands with float32 accumulation and a float32 result on an
    accelerator.  Takes (..., K) @ (K, N) or (V, V) @ (B, V, N)."""
    if a.device.type == "cpu":
        return a @ b
    return _folded_matmul(a, b, _Bf16Matmul.apply)


class GCNLayer(nn.Module):
    """One graph-convolution layer with the partial-aggregation "cut"."""

    def __init__(self, in_features: int, out_features: int, cut: float = 0.33,
                 do_cut: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.length = round(out_features * cut) if do_cut else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the reference's init: uniform(-s, s), s = 0.3 * 6 / sqrt(in + 1)
        stdv = 0.3 * 6.0 / math.sqrt(self.weight.shape[0] + 1)
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
            self.bias.uniform_(-0.1, 0.1, generator=generator)

    def forward(self, features: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        feats = _mxu_matmul(features, self.weight)  # (B, V, out)
        if self.length is None:
            return _mxu_matmul(adj, feats) + self.bias
        k = self.length
        shared = _mxu_matmul(adj, feats[..., :k]) + self.bias[:k]
        # quirk kept from the reference: in cut layers the bias is only added
        # to the aggregated slice
        return torch.cat([shared, feats[..., k:]], dim=-1)


class GCN(nn.Module):
    """Stack of GCNLayers: hidden layers ReLU + cut, final layer linear."""

    def __init__(self, in_features: int, num_layers: int, hidden_size: int,
                 out_size: int = 3, cut: float = 0.33):
        super().__init__()
        layers = []
        for i in range(num_layers):
            last = i == num_layers - 1
            layers.append(GCNLayer(
                in_features if i == 0 else hidden_size,
                out_size if last else hidden_size,
                cut,
                do_cut=not last,
            ))
        self.layers = nn.ModuleList(layers)

    def forward(self, features: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            features = layer(features, adj)
            if i < len(self.layers) - 1:
                features = F.relu(features)
        return features


class PositionalEncoder(nn.Module):
    """NeRF-embed vertex positions, then lift to ``out_size`` with an MLP."""

    def __init__(self, out_size: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Linear(63, out_size // 4),  # nerf_embedding: 3 x (2 x 10 + 1)
            nn.Linear(out_size // 4, out_size // 2),
            nn.Linear(out_size // 2, out_size),
        ])

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        x = nerf_embedding(positions)
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


class MaskEncoder(nn.Module):
    """Embed the per-vertex mask code {0, 1, 2, 3}."""

    def __init__(self, out_size: int):
        super().__init__()
        self.embed = nn.Embedding(4, out_size)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        return self.embed(mask.squeeze(-1).long())
