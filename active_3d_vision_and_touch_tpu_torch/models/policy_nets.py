"""Value networks of the learned active-selection policies.

Port of the JAX package's ``models/policy_nets.py``.

- :class:`LatentValueNet`: action-mask embedding + current and first shape
  latents → one value per action.  The supervised policy squashes it by a
  setting-dependent sigmoid (``policies/supervised/model.py:11-58`` of the
  reference); DDQN's latent variant does not (``policies/DDQN/model.py:16-61``).
- :class:`GraphValueNet`: mask embedding + NeRF positional + vertex-mask
  embeddings → a GCN over the fused atlas → vertex max-pool → action values
  (``policies/DDQN/model.py:65-128``).  Its products are those of
  :mod:`models.gcn`: bf16 operands with a float32 result on the card,
  float32 on the CPU.

Submodules map onto the flax names (see :mod:`convert`):
``mask_embed.dense.k`` = ``ActionMaskEmbed_0/Dense_k``, ``dense.k`` =
``Dense_k``, ``gcn.layers.i`` = ``GCNLayer_i``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from active_3d_vision_and_touch_tpu_torch.models.gcn import (
    GCN,
    MaskEncoder,
    PositionalEncoder,
)

# the sigmoid squashes of the supervised value net: half-width of the range
SQUASH = {None: None, "normalize": 1.0, "img": 3.0, "wide": 100.0}


class ActionMaskEmbed(nn.Module):
    """Embed the binary performed-actions mask: num_actions → 200 → 100 →
    out, ReLU between."""

    def __init__(self, num_actions: int, out_size: int):
        super().__init__()
        widths = (num_actions, 200, 100, out_size)
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dense[0](mask))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)


class LatentValueNet(nn.Module):
    """(mask (B, A), latent (B, L), first latent (B, L)) → (B, A) values:
    the mask embedding and both latents concatenated, ``layers - 1`` hidden
    ReLU layers, the action head, and the ``squash`` (None, "normalize"
    ±1, "img" ±3, "wide" ±100)."""

    def __init__(self, num_actions: int = 50, latent_size: int = 200, hidden_dim: int = 300,
                 layers: int = 5, squash: str | None = None):
        super().__init__()
        self.latent_size = latent_size
        self.half_range = SQUASH[squash]
        self.mask_embed = ActionMaskEmbed(num_actions, latent_size)
        widths = (3 * latent_size,) + (hidden_dim,) * (layers - 1) + (num_actions,)
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))

    def forward(self, mask: torch.Tensor, latent: torch.Tensor,
                first_latent: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.mask_embed(mask), latent, first_latent], dim=-1)
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        x = self.dense[-1](x)
        if self.half_range is None:
            return x
        return torch.sigmoid(x) * (2.0 * self.half_range) - self.half_range


class GraphValueNet(nn.Module):
    """(mask (B, A), mesh (B, V, 4) verts | mask code, adj (V, V)) → (B, A)
    values: the mask embedding broadcast over the vertices beside their
    positional and mask-code features, ``layers`` GCN layers (the last
    un-cut and without ReLU, out to the actions), a max over the
    vertices."""

    def __init__(self, num_actions: int = 50, hidden_dim: int = 100, layers: int = 5,
                 cut: float = 0.33, feature_size: int = 100):
        super().__init__()
        self.mask_embed = ActionMaskEmbed(num_actions, feature_size)
        self.positional = PositionalEncoder(feature_size)
        self.mask_enc = MaskEncoder(feature_size)
        self.gcn = GCN(3 * feature_size, layers, hidden_dim, num_actions, cut)

    def forward(self, mask: torch.Tensor, mesh: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        pos = self.positional(mesh[..., :3])
        codes = self.mask_enc(mesh[..., 3:])
        a = self.mask_embed(mask)[:, None, :].expand_as(pos)
        x = torch.cat([a, pos, codes], dim=-1)
        return self.gcn(x, adj).amax(dim=1)
