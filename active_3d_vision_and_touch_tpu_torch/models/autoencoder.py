"""Mesh autoencoder: predicted mesh → latent → folded point cloud.

Port of the JAX package's ``models/autoencoder.py``.  A GCN encoder runs
over the deformed chart-atlas mesh, max-pools over all vertices and
projects to a compact latent; a FoldingNet decoder folds a planar grid
through the latent twice into a ``grid_size²``-point cloud.  The latent is
the shape state the active policies read.

The GCN's products are those of :mod:`models.gcn` (bf16 operands with a
float32 result on the card); the decoder's Dense layers are plain float32
products.  Submodules map onto the flax names (see :mod:`convert`):
``encoder.gcn.layers.i`` = ``encoder/GCNLayer_i``, ``encoder.dense.k`` =
``encoder/Dense_k``, ``decoder.dense.k`` = ``decoder/Dense_k``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from active_3d_vision_and_touch_tpu_torch.models.gcn import (
    GCN,
    MaskEncoder,
    PositionalEncoder,
)


class GCNEncoder(nn.Module):
    """GCN stack → per-vertex features → max-pool → MLP → latent.  The
    last GCN layer aggregates every feature and has no ReLU."""

    def __init__(self, in_features: int, num_layers: int, hidden_size: int,
                 encoding_size: int, cut: float = 0.33):
        super().__init__()
        self.gcn = GCN(in_features, num_layers, hidden_size, hidden_size, cut)
        widths = (hidden_size, 500, 400, 300, encoding_size)
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))

    def forward(self, features: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        x = self.gcn(features, adj).amax(dim=1)  # vertex max-pool
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)


def folding_grid(grid_size: int = 80) -> np.ndarray:
    """(grid_size², 2) planar grid in [-0.5, 0.5]², as the JAX package
    builds it."""
    lin = np.linspace(-0.5, 0.5, grid_size, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


class FoldingDecoder(nn.Module):
    """Two folding passes of a planar grid conditioned on the latent:
    ``dense[0]`` makes a 512-wide code, ``dense[1:4]`` fold (code | grid)
    into xyz, ``dense[4:7]`` fold (code | first fold) into xyz."""

    def __init__(self, encoding_size: int, grid_size: int = 80):
        super().__init__()
        self.grid_size = grid_size
        self.register_buffer("grid", torch.from_numpy(folding_grid(grid_size)), persistent=False)
        widths = ((encoding_size, 512), (514, 512), (512, 512), (512, 3),
                  (515, 512), (512, 512), (512, 3))
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in widths)

    def _fold(self, code: torch.Tensor, points: torch.Tensor, first: int) -> torch.Tensor:
        """(B, 512) code, (B or 1, n, c) points → (B, n, 3) through
        ``dense[first:first + 3]``.  The first layer's product over
        (code | points) is split: the code's share is one row per cloud,
        broadcast over the points, rather than n equal rows."""
        layer, hidden, out = self.dense[first:first + 3]
        k = code.shape[-1]
        per_cloud = F.linear(code, layer.weight[:, :k], layer.bias)
        x = F.relu(F.linear(points, layer.weight[:, k:]) + per_cloud[:, None])
        return out(F.relu(hidden(x)))

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        code = self.dense[0](latent)  # (B, 512)
        fold1 = self._fold(code, self.grid[None], 1)
        return self._fold(code, fold1, 4)  # (B, grid_size², 3)


class MeshAutoEncoder(nn.Module):
    """verts + mask → latent (and optionally a decoded point cloud)."""

    def __init__(self, encoding_size: int = 200, num_gcn_layers: int = 20,
                 hidden_gcn_size: int = 300, cut: float = 0.33,
                 feature_size: int = 50, grid_size: int = 80):
        super().__init__()
        self.encoding_size = encoding_size
        self.positional = PositionalEncoder(feature_size)
        self.mask_enc = MaskEncoder(feature_size)
        self.encoder = GCNEncoder(feature_size, num_gcn_layers, hidden_gcn_size,
                                  encoding_size, cut)
        self.decoder = FoldingDecoder(encoding_size, grid_size)

    def encode(self, verts: torch.Tensor, mask: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        features = self.positional(verts) + self.mask_enc(mask)
        return self.encoder(features, adj)

    def forward(self, verts: torch.Tensor, mask: torch.Tensor, adj: torch.Tensor,
                only_encode: bool = False):
        """(decoded (B, grid_size², 3), latent (B, E)), or the latent alone
        with ``only_encode``."""
        latent = self.encode(verts, mask, adj)
        if only_encode:
            return latent
        return self.decoder(latent), latent
