"""Vision mesh deformation: image + touch charts → full surface mesh.

Port of the JAX package's ``models/vision.py``.  Two CNN pyramids encode
the RGB observation; chart vertices are projected into the image through
:class:`core.camera.PinholeCamera` and pool bilinear features from selected
pyramid levels; positional (NeRF) and mask embeddings complete the vertex
features; three GCN stages (stages 2 and 3 share ``gcn_2``) deform the
vision charts toward the object surface while the touch charts stay fixed.

Layouts: images are NHWC at :class:`Deformation`'s input, as in the JAX
package, and NCHW inside the encoders.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera
from active_3d_vision_and_touch_tpu_torch.models.gcn import (
    GCN,
    GCNLayer,
    MaskEncoder,
    PositionalEncoder,
)
from active_3d_vision_and_touch_tpu_torch.ops.grid_sample import sample_nchw


def encoder_plan(
    num_blocks: int = 6,
    layers_per_block: int = 3,
    kernel: int = 5,
    image_size: int = 256,
):
    """Static plan of the CNN pyramid: which layers run before the spatial
    size drops below the kernel, and which produce pooled feature maps.

    Returns (layer_specs, selected_ids, pooled_channels): layer_specs is a
    list of (features, stride, simple); selected_ids the indices whose
    outputs are pooled (3 intermediate + the final layer).
    """
    specs = [(3, 1, True)]
    cur, nxt = 3, 16
    for _ in range(num_blocks):
        specs.append((nxt, 2, False))
        cur = nxt
        nxt *= 2
        for _ in range(layers_per_block - 1):
            specs.append((cur, 1, False))
    total = len(specs)
    selections = {total - 1 - (i + 1) * layers_per_block for i in range(3)}

    run, selected, channels = [], [], []
    size = image_size
    for e, (feats, stride, simple) in enumerate(specs):
        if size < kernel:
            break
        run.append((feats, stride, simple))
        size = size // stride if stride > 1 else size
        if e in selections:
            selected.append(e)
            channels.append(feats)
    selected.append(len(run) - 1)
    channels.append(run[-1][0])
    return run, selected, channels


class BatchNorm(nn.Module):
    """Batch normalization over NCHW channels with flax's semantics.

    Train mode normalizes with the batch statistics and updates the running
    statistics as ``flax.linen.BatchNorm`` does: momentum 0.99 on the old
    value and the *biased* batch variance (``nn.BatchNorm2d`` would use
    momentum 0.01 on the new value and the unbiased variance).  Eval mode
    normalizes with the running statistics.  eps 1e-5 in both.

    With a ``group`` of more than one rank (:func:`sync_batchnorm_`) the
    batch statistics are those of the global batch, as under the JAX
    package's ``jit`` over a sharded batch: the ranks' counts, sums and
    sums of squares are added by a differentiable ``all_reduce`` (the
    gradient flows back to every rank's rows, as in ``SyncBatchNorm``), and
    the variance is flax's E[x²] - E[x]², floored at 0.
    """

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)

    def _global_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        sums = torch.cat([
            x.sum(dim=(0, 2, 3)),
            (x * x).sum(dim=(0, 2, 3)),
            x.new_full((1,), x.numel() // c),
        ])
        sums = all_reduce(sums, group=self.group)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c : 2 * c] / sums[2 * c] - mean * mean, min=0.0)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.group is not None:
            mean, var = self._global_moments(x)
            self._update_running(mean.detach(), var.detach())
            scale = self.weight * torch.rsqrt(var + self.eps)
            return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def sync_batchnorm_(module: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``module`` normalizes over the global batch of
    ``group``'s ranks in train mode (``group=None``: its own rows again)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


class ImageEncoder(nn.Module):
    """CNN pyramid over the RGB image (NCHW); returns the pooled maps.

    Built for a 256x256 image, as the JAX package's feature width is.  A
    smaller image runs when its plan is the same (the tests use 64x64 with
    3 blocks).  ``norms[j]`` is the j-th BatchNorm, the layer order of
    flax's ``BatchNorm_j``.
    """

    def __init__(self, num_blocks: int = 6, layers_per_block: int = 3, kernel: int = 5):
        super().__init__()
        self.plan_args = (num_blocks, layers_per_block, kernel)
        specs, self.selected, _ = encoder_plan(*self.plan_args)
        self.specs = specs
        convs, norms = [], []
        cin = 3
        for features, stride, simple in specs:
            if not simple:
                norms.append(BatchNorm(cin))
            convs.append(nn.Conv2d(cin, features, kernel, stride, (kernel - 1) // 2))
            cin = features
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        specs, selected, _ = encoder_plan(*self.plan_args, img.shape[2])
        if specs != self.specs or selected != self.selected:
            raise ValueError(
                f"a {img.shape[2]}px image runs another pyramid than a 256px one"
            )
        feats = []
        x = img
        norms = iter(self.norms)
        for e, ((_, _, simple), conv) in enumerate(zip(self.specs, self.convs)):
            if not simple:
                x = F.relu(next(norms)(x))
            x = conv(x)
            if e in self.selected:
                feats.append(x)
        return feats


def pool_image_features(
    feature_maps: list[torch.Tensor], verts: torch.Tensor, camera: PinholeCamera
) -> torch.Tensor:
    """Project vertices through the camera and gather bilinear features from
    every pyramid level → (B, V, Σ channels)."""
    grid = camera.normalized_grid(verts)
    return torch.cat([sample_nchw(fmap, grid) for fmap in feature_maps], dim=-1)


def chart_plane_features(
    t_pos: torch.Tensor, contact: torch.Tensor, n: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chart plane features from the n x n touch-chart grids.

    A contact chart pins the local surface plane.  The chart is a deformed
    row-major (n x n) sheet (``core/mesh.py::touch_chart``), so the grid
    tangents give a closed-form normal without an eigendecomposition.

    t_pos (B, V, 3) chart vertices, contact (B, V, 1) in {0, 1} →
    ``(feats, has)``: feats (B, C, 8) = [n n^T upper triangle (6) |
    planarity | residual rms] per chart (n n^T is sign-invariant, so the
    arbitrary orientation of the sheet's tangents cannot flip it) and has
    (B, C, 1), the per-chart contact indicator.  Non-contact charts are
    zeroed.
    """
    b, v, _ = t_pos.shape
    c = v // (n * n)
    tc = t_pos.reshape(b, c, n, n, 3)
    # a chart counts as contact if ANY of its slots does
    has = contact.reshape(b, c, n * n, 1).amax(dim=2)
    tu = (tc[:, :, 1:] - tc[:, :, :-1]).mean(dim=(2, 3))
    tv = (tc[:, :, :, 1:] - tc[:, :, :, :-1]).mean(dim=(2, 3))
    # double-where guard: padded and degenerate charts have a zero cross
    # product, and the norm's gradient at zero is NaN, which a clamp on the
    # norm alone does not stop (0 * NaN = NaN through the unselected
    # branch).  A safe unit vector goes in INSIDE the norm instead.
    cross = torch.linalg.cross(tu, tv, dim=-1)
    degen = cross.square().sum(dim=-1, keepdim=True) < 1e-24
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=t_pos.dtype, device=t_pos.device)
    safe = torch.where(degen, e3.expand_as(cross), cross)
    nrm = safe / torch.linalg.vector_norm(safe, dim=-1, keepdim=True)
    flat = tc.reshape(b, c, n * n, 3)
    d = flat - flat.mean(dim=2, keepdim=True)
    var_n = (d * nrm[:, :, None, :]).sum(-1).square().mean(-1)  # (B, C)
    tot = d.square().sum(-1).mean(-1)
    planarity = 1.0 - var_n / torch.clamp(tot, min=1e-12)
    rms = torch.sqrt(var_n + 1e-12)
    iu, ju = torch.triu_indices(3, 3, device=t_pos.device)
    nnt = (nrm[..., :, None] * nrm[..., None, :])[..., iu, ju]  # (B, C, 6)
    feats = torch.cat([nnt, planarity[..., None], rms[..., None]], dim=-1)
    return feats * has, has


class Deformation(nn.Module):
    """Three-stage GCN chart deformation.

    ``touch_global`` pools the contact charts' positional features and raw
    coordinate statistics into one context vector per object, broadcast to
    every vertex at every stage; ``touch_plane`` adds each contact chart's
    fitted plane, pooled into that context and per vertex at the touch
    tail.  Both are off by default, as in the JAX package.

    Submodules map onto the flax names: ``positional`` =
    PositionalEncoder_0, ``mask_enc`` = MaskEncoder_0, ``gcn_1``/``gcn_2`` =
    GCN_0/GCN_1, ``global_encoder``/``local_encoder`` =
    ImageEncoder_0/ImageEncoder_1, and ``touch_context``, ``plane_context``,
    ``plane_vertex`` the Dense layers of those names (see :mod:`convert`).
    """

    def __init__(
        self,
        use_img: bool = True,
        use_touch: bool = True,
        touch_global: bool = False,
        touch_plane: bool = False,
        num_gcn_layers: int = 20,
        hidden_gcn_size: int = 300,
        cut: float = 0.33,
        num_cnn_blocks: int = 6,
        layers_per_block: int = 3,
        cnn_kernel: int = 5,
        camera: PinholeCamera = PinholeCamera(),
    ):
        super().__init__()
        self.use_img = use_img
        self.use_touch = use_touch
        self.touch_global = use_touch and touch_global
        self.touch_plane = use_touch and touch_plane
        self.camera = camera
        if use_img:
            _, _, channels = encoder_plan(num_cnn_blocks, layers_per_block, cnn_kernel)
            fsize = sum(channels)
        else:
            fsize = 50
        self.feature_size = fsize
        self.positional = PositionalEncoder(fsize)
        self.mask_enc = MaskEncoder(fsize)
        self.gcn_1 = GCN(fsize, num_gcn_layers, hidden_gcn_size, 3, cut)
        self.gcn_2 = GCN(fsize, num_gcn_layers, hidden_gcn_size, 3, cut)
        if use_img:
            enc = (num_cnn_blocks, layers_per_block, cnn_kernel)
            self.global_encoder = ImageEncoder(*enc)
            self.local_encoder = ImageEncoder(*enc)
        if self.touch_global:
            # mean and max of the positional features, 4 x 3 coordinate
            # statistics, the contact fraction
            self.touch_context = nn.Linear(2 * fsize + 12 + 1, fsize)
        if self.touch_plane:
            self.plane_context = nn.Linear(2 * 8, fsize)
            self.plane_vertex = nn.Linear(8, fsize)

    def _touch_context(self, t_pos: torch.Tensor, contact: torch.Tensor) -> torch.Tensor:
        """(B, 1, fsize) global context of the contact set; finite (and with
        finite gradients) when no slot is in contact."""
        t_feat = self.positional(t_pos)  # shared with the vertex encoding
        count = contact.sum(dim=1)  # (B, 1)
        n_contact = torch.clamp(count, min=1.0)
        has = count > 0
        on = contact > 0
        zero = t_pos.new_zeros(())
        ctx_mean = (t_feat * contact).sum(dim=1) / n_contact
        ctx_max = torch.where(has, t_feat.masked_fill(~on, -1e9).amax(dim=1), zero)
        # raw per-axis statistics of the contact set: contacts lower-bound
        # the object's extent along their directions
        p_mean = (t_pos * contact).sum(dim=1) / n_contact
        p_max = torch.where(has, t_pos.masked_fill(~on, -1e9).amax(dim=1), zero)
        p_min = torch.where(has, t_pos.masked_fill(~on, 1e9).amin(dim=1), zero)
        p_var = ((t_pos - p_mean[:, None, :]).square() * contact).sum(dim=1) / n_contact
        frac = contact.mean(dim=1)  # share of slots in contact
        stats = torch.where(
            has, torch.cat([p_mean, p_max, p_min, torch.sqrt(p_var + 1e-8)], dim=-1), zero
        )
        ctx = torch.cat([ctx_mean, ctx_max, 3.0 * stats, frac], dim=-1)
        return self.touch_context(ctx)[:, None, :]

    def _plane_context(self, t_pos: torch.Tensor, contact: torch.Tensor):
        """((B, 1, fsize) pooled plane context, (B, Vt, fsize) per-vertex
        plane features of the touch tail)."""
        pf, phas = chart_plane_features(t_pos, contact)
        count = phas.sum(dim=1)  # (B, 1)
        pf_mean = pf.sum(dim=1) / torch.clamp(count, min=1.0)
        pf_max = torch.where(
            count > 0, pf.masked_fill(~(phas > 0), -1e9).amax(dim=1), pf.new_zeros(())
        )
        ctx = self.plane_context(torch.cat([pf_mean, pf_max], dim=-1))[:, None, :]
        verts_per_chart = t_pos.shape[1] // pf.shape[1]
        tail = self.plane_vertex(pf.repeat_interleave(verts_per_chart, dim=1))
        return ctx, tail

    def forward(
        self,
        img: torch.Tensor | None,
        charts: dict,
        adj: torch.Tensor,
        original_adj: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (verts (B, V, 3), mask (B, V, 1)); ``img`` is NHWC."""
        vc = charts["vision_charts"].shape[1]
        touch_ctx, plane_tail = None, None
        if self.touch_global or self.touch_plane:
            t_pos = charts["touch_charts"]
            contact = (charts["touch_masks"] == 2.0).to(t_pos.dtype)
            if self.touch_global:
                touch_ctx = self._touch_context(t_pos, contact)
            if self.touch_plane:
                plane_ctx, plane_tail = self._plane_context(t_pos, contact)
                touch_ctx = plane_ctx if touch_ctx is None else touch_ctx + plane_ctx

        def embed(vertices: torch.Tensor, mask_features: torch.Tensor) -> torch.Tensor:
            features = self.positional(vertices) + mask_features
            # per-vertex plane features at the touch tail [vc:], where present
            if plane_tail is not None and features.shape[1] != vc:
                features = torch.cat(
                    [features[:, :vc], features[:, vc:] + plane_tail], dim=1
                )
            return features if touch_ctx is None else features + touch_ctx

        if self.use_img:
            x = img.permute(0, 3, 1, 2)  # NHWC → NCHW (a channels-last view)
            global_feats = self.global_encoder(x)
            local_feats = self.local_encoder(x)

        # ---- stage 1: touch-only starts fused; vision starts charts-only
        if self.use_touch and not self.use_img:
            vertices = torch.cat([charts["vision_charts"], charts["touch_charts"]], dim=1)
            mask = torch.cat([charts["vision_masks"], charts["touch_masks"]], dim=1)
            features = embed(vertices, self.mask_enc(mask))
            stage1_adj = adj
        else:
            vertices = charts["vision_charts"]
            mask = charts["vision_masks"]
            features = embed(vertices, self.mask_enc(mask))
            if self.use_img:
                features = features + pool_image_features(global_feats, vertices, self.camera)
            # with image features, stage 1 deforms the vision atlas alone
            stage1_adj = original_adj if self.use_img else adj
        update = self.gcn_1(features, stage1_adj)
        vertices = torch.cat([vertices[:, :vc] + update[:, :vc], vertices[:, vc:]], dim=1)

        # ---- stage 2: append touch charts if not already present
        if self.use_touch and self.use_img:
            vertices = torch.cat([vertices, charts["touch_charts"]], dim=1)
            mask = torch.cat([charts["vision_masks"], charts["touch_masks"]], dim=1)
        mask_features = self.mask_enc(mask)
        for _ in range(2):  # stages 2 and 3 share gcn_2, features refreshed
            features = embed(vertices, mask_features)
            if self.use_img:
                features = features + pool_image_features(local_feats, vertices, self.camera)
            update = self.gcn_2(features, adj)
            vertices = torch.cat([vertices[:, :vc] + update[:, :vc], vertices[:, vc:]], dim=1)
        return vertices, mask


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's lecun_normal: truncated normal at +-2 std, rescaled to unit variance
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_modules_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter of a model of this package (``Deformation``,
    ``TouchChartEncoder``) from ``generator`` with the JAX package's
    initializers: lecun-normal kernels and zero biases for Conv/Dense, the
    reference's uniform GCN init, N(0, 1/4)-truncated mask embeddings, unit
    BatchNorm scales."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                _lecun_normal_(mod.weight, mod.num_embeddings, generator)
            elif isinstance(mod, GCNLayer):
                mod.reset_parameters(generator)
    return model


def prepare_charts(
    touch_charts: torch.Tensor | None,
    vision_mesh: torch.Tensor,
    batch_size: int,
    use_touch: bool = True,
) -> dict:
    """Assemble the model-input chart dict.

    ``touch_charts``: (B, ..., 25, 4) stacked [xyz | mask] slots;
    ``vision_mesh``: (Vv, 3) canonical atlas.  Vision verts carry mask code 3.
    """
    vision_charts = vision_mesh[None].expand(batch_size, -1, -1)
    vision_masks = torch.full(
        (batch_size, vision_mesh.shape[0], 1), 3.0,
        dtype=vision_mesh.dtype, device=vision_mesh.device,
    )
    charts = {"vision_charts": vision_charts, "vision_masks": vision_masks}
    if use_touch:
        info = touch_charts.reshape(batch_size, -1, 4)
        charts["touch_charts"] = info[..., :3]
        charts["touch_masks"] = info[..., 3:]
    return charts
