"""Plain reference of the touch-chart model, its 3-repeat Chamfer loss and
its Adam step, after the published description (pterotactyl
``reconstruction/touch/model.py:35-74`` and ``touch/train.py:203-255``;
Smith et al., arXiv 2107.09584), in plain PyTorch.

- Six blocks of three 5x5 convolutions, 3 -> 16 -> 32 -> 32 -> 64 -> 128
  -> 128 features, the first of each block at stride 2 (121 -> 61 -> 31
  -> 16 -> 8 -> 4 -> 2), each followed by BatchNorm and a ReLU but the
  last block's last convolution.
- An MLP 512 -> 256 -> 128 -> 75 (ReLUs between) gives 25 vertex offsets,
  added to the canonical 5x5 chart (``atlas.touch_sheet``, 32 faces); the
  chart is moved into the fingertip's frame, ``R @ v + t``.
- The loss: ``3 * num_samples`` area-weighted samples of each chart
  (``vision.Reference.sample``, from the benchmark's drawn noise), split
  into 3 clouds, each against the row's touch cloud by the symmetric
  Chamfer distance (squared, mean over points) by exact search in blocks
  (``vision.exact_nearest``), averaged, times ``loss_coeff``, meaned over
  the batch.
- BatchNorm in train mode normalises with the batch's biased variance,
  eps 1e-5; in eval mode with the running statistics.

Departures from the published model, all of form: the gel image comes in
as (B, H, W, 3) and the last map is flattened in (h, w, c) order, which
permutes the first dense layer's rows; the running statistics are
neither updated nor compared (train mode never reads them); the sampler
takes its random numbers from the caller.

Precision, as the configuration states: float32, with TF32 off for every
product and convolution; on an accelerator each convolution, forward and
backward, takes its two operands rounded to TF32 (10 bits of mantissa, to
nearest) and sums in float32, as the configuration's TF32 convolutions
do.  ``dtype=torch.bfloat16`` computes every part in bfloat16 instead:
the control.  Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.atlas import touch_sheet
from benchmark.reference.vision import Reference

FEATURES = (16, 32, 32, 64, 128, 128)
KERNEL = 5
MLP = (512, 256, 128, 75)


def tf32(x):
    """``x`` (float32) rounded to TF32's 10 bits of mantissa, to nearest,
    ties to even, and kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class _Tf32Conv(torch.autograd.Function):
    """A 5x5 convolution on TF32-rounded operands with float32 sums; each
    product of the backward rounds its two operands the same way."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int):
        xt, wt = tf32(x), tf32(w)
        ctx.save_for_backward(xt, wt)
        ctx.stride = stride
        return F.conv2d(xt, wt, b, stride=stride, padding=(KERNEL - 1) // 2)

    @staticmethod
    def backward(ctx, g):
        xt, wt = ctx.saved_tensors
        gt, s, pad = tf32(g), ctx.stride, (KERNEL - 1) // 2
        need = ctx.needs_input_grad
        gx = torch.nn.grad.conv2d_input(xt.shape, wt, gt, stride=s, padding=pad) if need[0] else None
        gw = torch.nn.grad.conv2d_weight(xt, wt.shape, gt, stride=s, padding=pad) if need[1] else None
        return gx, gw, g.sum(dim=(0, 2, 3)) if need[2] else None, None


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every weight and BatchNorm statistic,
    named as the port's ``TouchChartEncoder.state_dict()`` names them.  The
    last dense layer (the vertex offsets) takes the kinds of the GCN
    stacks' vertex update, 1/20 of the published init, so that the chart
    keeps the sensor's size and lies on its touch cloud, as past the first
    steps of a training."""
    out, cin = [], 3
    for i, feats in enumerate(FEATURES):
        norms = 2 if i == len(FEATURES) - 1 else 3
        for k in range(3):
            a = cin if k == 0 else feats
            out += [(f"blocks.{i}.convs.{k}.weight", (feats, a, KERNEL, KERNEL), "conv", a * KERNEL * KERNEL),
                    (f"blocks.{i}.convs.{k}.bias", (feats,), "bias", a * KERNEL * KERNEL)]
        for k in range(norms):
            for stat, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                               ("running_mean", "bn_mean"), ("running_var", "bn_var")):
                out.append((f"blocks.{i}.norms.{k}.{stat}", (feats,), kind, feats))
        cin = feats
    for k, (a, b) in enumerate(zip(MLP, MLP[1:])):
        last = k == len(MLP) - 2
        out += [(f"dense.{k}.weight", (b, a), "gcn_out" if last else "dense", a),
                (f"dense.{k}.bias", (b,), "gcn_out_bias" if last else "bias", a)]
    return out


class TouchReference(Reference):
    """The touch-chart model of ``cfg`` (a TouchConfig as a dict, with
    ``repeat``) on ``device`` in ``dtype``.  The sampler, the search, the
    Chamfer distance, BatchNorm and the loss are the vision reference's."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the convolutions' TF32 rounding, emulated on an accelerator (the
        # CPU has none: the program's convolutions run in float32 there)
        self.tf32_convs = self.device.type == "cuda" and dtype == torch.float32
        verts, faces = touch_sheet()
        self.chart = torch.as_tensor(verts, device=self.device).to(dtype)
        self.faces = torch.as_tensor(faces, device=self.device).long()

    def _conv(self, x, w, b, stride: int):
        if self.tf32_convs:
            return _Tf32Conv.apply(x, w, b, stride)
        return F.conv2d(x, w, b, stride=stride, padding=(KERNEL - 1) // 2)

    def encode(self, p, touch, pos, rot, train: bool):
        """(B, 25, 3) charts in the fingertip frames for gel images (B, H,
        W, 3), positions (B, 3) and rotations (B, 3, 3)."""
        x = touch.permute(0, 3, 1, 2)
        for i in range(len(FEATURES)):
            norms = 2 if i == len(FEATURES) - 1 else 3
            for k in range(3):
                x = self._conv(x, p[f"blocks.{i}.convs.{k}.weight"], p[f"blocks.{i}.convs.{k}.bias"],
                               2 if k == 0 else 1)
                if k < norms:
                    x = F.relu(self._bn(p, f"blocks.{i}.norms.{k}", x, train))
        x = x.permute(0, 2, 3, 1).flatten(1)
        for k in range(len(MLP) - 1):
            x = F.linear(x, p[f"dense.{k}.weight"], p[f"dense.{k}.bias"])
            x = F.relu(x) if k < len(MLP) - 2 else x
        verts = self.chart + x.reshape(x.shape[0], -1, 3)
        return rigid(verts, pos, rot)

    def row_distances(self, p, batch, draws, train: bool):
        """(B,) 3-repeat Chamfer distance of each row's chart to its cloud."""
        b = batch["sim_touch"].shape[0]
        verts = self.encode(p, *(batch[k].to(self.dtype) for k in ("sim_touch", "ref_pos", "ref_rot")), train)
        num = self.cfg["num_samples"]
        pts = self.sample(verts, draws)
        repeat = pts.shape[1] // num
        preds = torch.cat(torch.split(pts, num, dim=1), dim=0)
        gt = batch["samples"].to(self.dtype).repeat(repeat, 1, 1)
        return self.chamfer(preds, gt).reshape(repeat, b).mean(dim=0)


def rigid(verts, pos, rot):
    """``R @ v + t`` for each row's vertices (B, V, 3)."""
    return torch.matmul(verts, rot.transpose(1, 2)) + pos[:, None, :]
