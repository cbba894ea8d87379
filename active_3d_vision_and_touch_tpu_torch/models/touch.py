"""Touch-chart prediction: tactile image → deformed 25-vertex chart.

Port of the JAX package's ``models/touch.py``.  A small CNN encodes the
121x121 simulated gel image; an MLP decodes 25 vertex offsets applied to
the canonical touch chart; the chart is then moved rigidly into the world
frame of the sensing fingertip.

Layouts: the image is NHWC at the module's input, as in the JAX package,
and NCHW inside.  The flax model flattens the last NHWC map (2, 2, 128) in
(h, w, c) order; this one permutes back to NHWC before the flatten, so the
first Dense layer's rows keep their meaning (see :mod:`convert`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from active_3d_vision_and_touch_tpu_torch.models.vision import BatchNorm

_FEATURES = (16, 32, 32, 64, 128, 128)  # 121 → 61 → 31 → 16 → 8 → 4 → 2


class DoubleConv(nn.Module):
    """conv(s2) → BN → ReLU → conv → BN → ReLU → conv [→ BN → ReLU].
    ``convs[k]``/``norms[k]`` are flax's ``Conv_k``/``BatchNorm_k``."""

    def __init__(self, in_features: int, features: int, last: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_features, features, 5, 2, 2),
            nn.Conv2d(features, features, 5, 1, 2),
            nn.Conv2d(features, features, 5, 1, 2),
        ])
        self.norms = nn.ModuleList([BatchNorm(features) for _ in range(2 if last else 3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k, conv in enumerate(self.convs):
            x = conv(x)
            if k < len(self.norms):
                x = F.relu(self.norms[k](x))
        return x


class TouchChartEncoder(nn.Module):
    """121x121x3 gel image → (25, 3) chart vertices in the world frame.
    ``blocks[i]`` is flax's ``DoubleConv_i``, ``dense[k]`` its ``Dense_k``."""

    def __init__(self, num_verts: int = 25):
        super().__init__()
        self.num_verts = num_verts
        ins = (3,) + _FEATURES[:-1]
        self.blocks = nn.ModuleList([
            DoubleConv(cin, feats, last=i == len(_FEATURES) - 1)
            for i, (cin, feats) in enumerate(zip(ins, _FEATURES))
        ])
        self.dense = nn.ModuleList([
            nn.Linear(2 * 2 * 128, 256), nn.Linear(256, 128), nn.Linear(128, num_verts * 3),
        ])

    def predict_verts(self, touch: torch.Tensor) -> torch.Tensor:
        x = touch.permute(0, 3, 1, 2)  # NHWC → NCHW
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (B, 2*2*128) in flax's order
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x).reshape(-1, self.num_verts, 3)

    def forward(
        self,
        touch: torch.Tensor,  # (B, 121, 121, 3) in [0, 1]
        ref_pos: torch.Tensor,  # (B, 3) fingertip position
        ref_rot: torch.Tensor,  # (B, 3, 3) fingertip rotation
        chart_verts: torch.Tensor,  # (25, 3) canonical chart
    ) -> torch.Tensor:
        verts = chart_verts[None] + self.predict_verts(touch)  # (B, 25, 3)
        # rigid transform into the sensor frame: R @ v + t
        return torch.einsum("bij,bvj->bvi", ref_rot, verts) + ref_pos[:, None, :]
