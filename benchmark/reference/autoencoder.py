"""Plain reference of the mesh-autoencoder trainer's step: the frozen v_t_g
deformation in eval mode, and apart from it the autoencoder, its 3-repeat
Chamfer loss and its Adam step, after the published description
(pterotactyl ``reconstruction/autoencoder/model.py:16-264``, ``AutoEncoder``,
``Encoder``, ``FoldingNetDec``, and ``autoencoder/train.py:128-166``;
Smith et al., arXiv 2107.09584), in plain PyTorch.

- The frozen deformation (:class:`FrozenVision`): the v_t_g model of
  ``vision.Reference``, BatchNorm on its running statistics, no gradient.
- The encoder: a positional MLP (63 -> f/4 -> f/2 -> f) of each deformed
  vertex's NeRF embedding plus its mask code's embedding; a GCN stack of
  ``num_gcn_layers`` x ``hidden_gcn_size`` over the deformed mesh's
  adjacency (hidden layers aggregate the first ``round(cut * out)``
  columns and take a ReLU; the last aggregates every column and takes
  none); a max over all vertices; an MLP -> 500 -> 400 -> 300 -> the
  latent, ReLUs between.
- The FoldingNet decoder: the latent to a 512-wide code; two folds, each
  the code beside each point (the ``grid_size``² grid in [-0.5, 0.5]², then
  the first fold's points) through 512 -> 512 -> 3, ReLUs between.
- The loss: ``3 * number_points`` area-weighted samples of each frozen
  mesh (``vision.Reference.sample``, from the benchmark's drawn noise),
  split into 3 clouds, each against the decoded cloud by the symmetric
  Chamfer distance (squared, mean over points) by exact search in blocks
  (``vision.exact_nearest``), averaged, times ``loss_coeff``, meaned over
  the batch.  pterotactyl's loss is exact too; the JAX package's inherited
  "clustered" default, which passes no gradient to the decoded cloud, is
  not followed.
- Adam: ``vision.train_steps``.

Departures from the published model, all of form: each fold's first
layer takes its input as (code | points), a (512 + 2)- or (512 + 3)-wide
row per point, where the published one is a 1x1 convolution over the
same rows; the grid is laid out row by row, x fastest; the sampler takes
its random numbers from the caller.

Precision, as the configuration states: float32, with TF32 off for every
product and convolution; on an accelerator the GCN's two products take bf16-rounded
operands and sum in float32 (``vision.Reference._mm``), in both models,
and each convolution of the frozen model takes its two operands rounded
to TF32 (``touch.tf32``), as cuDNN's TF32 convolutions do.  The decoder
and the MLPs are full float32.  ``dtype=torch.bfloat16`` computes every
part in bfloat16 instead: the control; ``tf32_decoder=True`` rounds every
operand of the decoder's products to TF32 instead, forward and backward
(the decoder as TF32 GEMMs would run it): the second control.  Nothing
here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.touch import tf32
from benchmark.reference.vision import Reference, cast, half_rows, is_parameter

DENSE = (500, 400, 300)  # the encoder's MLP between the pooled features and the latent
CODE = 512  # the decoder's code and fold width


def folding_grid(size: int) -> np.ndarray:
    """(size², 2) points of a size x size grid over [-0.5, 0.5]², row by
    row, x fastest."""
    lin = np.linspace(-0.5, 0.5, size, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def decoder_widths(encoding: int) -> list[tuple[int, int]]:
    """(in, out) of the decoder's seven layers: the code, then each fold's
    three."""
    return [(encoding, CODE), (CODE + 2, CODE), (CODE, CODE), (CODE, 3),
            (CODE + 3, CODE), (CODE, CODE), (CODE, 3)]


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every leaf of the autoencoder of
    ``cfg`` (an AutoencoderConfig as a dict, with ``feature_size``), named
    as the port's ``MeshAutoEncoder.state_dict()`` names them; the kinds
    of ``weights.module_specs`` (GCN layers by the published GCN init,
    dense layers by their fan-in), but in the decoder: the code layer at
    1/20 of the GCN init (kind ``gcn_out``) and each fold's first layer by
    the He init over its 2 or 3 point columns (kind ``conv``).  So each
    point's place on the grid spreads the decoded cloud over about the
    frozen mesh's size, as a trained decoder's cloud covers its object;
    at the plain init the code outweighs the grid's 2 columns and every
    cloud collapses to within 1e-3 of a point, where ties decide each
    sample's nearest decoded point."""
    f, h, layers = cfg["feature_size"], cfg["hidden_gcn_size"], cfg["num_gcn_layers"]
    out = []

    def dense(prefix, widths, kinds=None):
        for k, (a, b) in enumerate(widths):
            kind, fan = (kinds or {}).get(k, ("dense", a))
            out.extend([(f"{prefix}.{k}.weight", (b, a), kind, fan), (f"{prefix}.{k}.bias", (b,), "bias", 1)])

    dense("positional.layers", [(63, f // 4), (f // 4, f // 2), (f // 2, f)])
    out.append(("mask_enc.embed.weight", (4, f), "embed", 4))
    for i in range(layers):
        a = f if i == 0 else h
        out.extend([(f"encoder.gcn.layers.{i}.weight", (a, h), "gcn", a),
                    (f"encoder.gcn.layers.{i}.bias", (h,), "gcn_bias", 1)])
    widths = (h, *DENSE, cfg["encoding_size"])
    dense("encoder.dense", list(zip(widths, widths[1:])))
    w = decoder_widths(cfg["encoding_size"])
    dense("decoder.dense", w, {0: ("gcn_out", w[0][0]), 1: ("conv", 2), 4: ("conv", 3)})
    return out


class FrozenVision(Reference):
    """The v_t_g deformation of ``cfg`` (a VisionConfig as a dict) in eval
    mode, on ``device`` in ``dtype``; on an accelerator in float32 each
    convolution takes TF32-rounded operands (the CPU has none: the
    program's convolutions run in float32 there)."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        super().__init__(cfg, device, dtype)
        self.tf32_convs = self.device.type == "cuda" and dtype == torch.float32

    def _encoder(self, p, prefix, x, train):
        feats, n, k = [], 0, self.cfg["cnn_kernel"]
        for e, (_, stride, simple) in enumerate(self.specs):
            if not simple:
                x = F.relu(self._bn(p, f"{prefix}.norms.{n}", x, train))
                n += 1
            w = p[f"{prefix}.convs.{e}.weight"]
            if self.tf32_convs:
                x, w = tf32(x), tf32(w)
            x = F.conv2d(x, w, p[f"{prefix}.convs.{e}.bias"], stride=stride, padding=(k - 1) // 2)
            if e in self.selected:
                feats.append(x)
        return feats

    @torch.no_grad()
    def deform_eval(self, p: dict, batch: dict):
        """(B, V, 3) frozen vertices of a vision batch (``img`` (B, H, W, 3),
        ``touch_charts`` (B, grasps, 4, 25, 4)); cuDNN's TF32 off while it
        runs, so that only the rounding above takes TF32's bits."""
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self.deform(p, batch["img"].to(self.dtype), batch["touch_charts"].to(self.dtype), train=False)
        finally:
            torch.backends.cudnn.allow_tf32 = allow


class _Tf32Linear(torch.autograd.Function):
    """``x @ w.T + b`` on TF32-rounded operands with float32 sums; each
    product of the backward rounds its two operands the same way."""

    @staticmethod
    def forward(ctx, x, w, b):
        xt, wt = tf32(x), tf32(w)
        ctx.save_for_backward(xt, wt)
        return F.linear(xt, wt, b)

    @staticmethod
    def backward(ctx, g):
        xt, wt = ctx.saved_tensors
        gt, need = tf32(g), ctx.needs_input_grad
        gx = gt @ wt if need[0] else None
        gw = gt.flatten(0, -2).T @ xt.flatten(0, -2) if need[1] else None
        return gx, gw, g.flatten(0, -2).sum(0) if need[2] else None


class AutoencoderReference(Reference):
    """The autoencoder of ``cfg`` (an AutoencoderConfig as a dict, with
    ``feature_size`` and ``repeat``) on ``device`` in ``dtype``, over the
    deformed atlas's adjacency and faces.  Its batches are the frozen
    model's output: ``verts`` (B, V, 3) and ``mask`` (B, V, 1) codes."""

    def __init__(self, cfg: dict, device, dtype=torch.float32, tf32_decoder: bool = False):
        super().__init__(cfg, device, dtype)
        self.grid = torch.as_tensor(folding_grid(cfg["grid_size"]), device=self.device).to(dtype)
        self.linear = _Tf32Linear.apply if tf32_decoder else F.linear

    def encode(self, p, verts, mask):
        """(B, latent) of the meshes."""
        x = self._positional(p, verts) + p["mask_enc.embed.weight"][mask[..., 0].long()]
        x = self._gcn(p, "encoder.gcn", x, self.adj).amax(dim=1)
        for k in range(len(DENSE) + 1):
            x = F.linear(x, p[f"encoder.dense.{k}.weight"], p[f"encoder.dense.{k}.bias"])
            x = F.relu(x) if k < len(DENSE) else x
        return x

    def decode(self, p, latent):
        """(B, grid_size², 3) decoded clouds."""
        code = self.linear(latent, p["decoder.dense.0.weight"], p["decoder.dense.0.bias"])
        b, n = code.shape[0], self.grid.shape[0]
        x = self.grid[None].expand(b, -1, -1)
        for first in (1, 4):
            x = torch.cat([code[:, None].expand(-1, n, -1), x], dim=-1)
            for k in range(3):
                x = self.linear(x, p[f"decoder.dense.{first + k}.weight"], p[f"decoder.dense.{first + k}.bias"])
                x = F.relu(x) if k < 2 else x
        return x

    def row_distances(self, p, batch, draws, train: bool):
        """(B,) 3-repeat Chamfer distance of each frozen mesh's samples to
        its decoded cloud."""
        verts = batch["verts"].to(self.dtype)
        decoded = self.decode(p, self.encode(p, verts, batch["mask"]))
        num, b = self.cfg["number_points"], verts.shape[0]
        pts = self.sample(verts, draws)
        repeat = pts.shape[1] // num
        preds = torch.cat(torch.split(pts, num, dim=1), dim=0)
        return self.chamfer(preds, decoded.repeat(repeat, 1, 1)).reshape(repeat, b).mean(dim=0)


def first_gradients(ref: Reference, weights: dict, batch: dict, draws: tuple, fault: str | None = None) -> dict:
    """Each parameter's gradient at ``weights`` over one batch, in float32:
    the gradient of ``vision.train_steps``'s first step, with its
    ``fault``."""
    p = cast(weights, ref.dtype, ref.device)
    names = [k for k in p if is_parameter(k)]
    if fault == "half":
        batch, draws = half_rows(batch, draws)
    for k in names:
        p[k].requires_grad_(True)
    loss = ref.loss(p, batch, draws, train=True, fault=fault if fault == "row0x2" else None)
    return {k: g.float() for k, g in zip(names, torch.autograd.grad(loss, [p[k] for k in names]))}
