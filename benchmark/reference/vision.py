"""Plain reference of the v_t_g vision+touch deformation model, its
3-repeat Chamfer loss and its Adam step, after the published description
(pterotactyl ``reconstruction/vision/model.py`` and ``train.py``; Smith
et al., arXiv 2107.09584), in plain PyTorch.

- Two CNN pyramids (a 5x5 convolution on the image, then blocks of
  BatchNorm, ReLU and 5x5 convolutions, the first of each block at
  stride 2, run while the map is at least the kernel's size) whose
  selected maps are pooled bilinearly at each vertex's projection.
- Vertex features: a NeRF embedding through a 3-layer MLP, a mask-code
  embedding and the pooled image features.  Three GCN stages (the second
  and third share weights) move the vision vertices; touch charts stay.
- A GCN layer is ``features @ W``, then the adjacency times the first
  ``round(cut * out)`` columns plus their bias; hidden layers take a ReLU.
- The loss: ``3 * number_points`` area-weighted samples of the mesh, split
  into 3 clouds, each against the gt cloud by the symmetric Chamfer
  distance (squared, mean over points), averaged, times ``loss_coeff``.
  Each point's neighbour is found as the configuration states: by the
  exact search, or (``loss_nn`` "clustered") by the clustered search that
  ``clustered_search`` sizes (:func:`clustered_nearest`); the distance is
  taken again from the coordinates of the neighbour found.
- BatchNorm in train mode normalises with the batch's biased variance,
  eps 1e-5; in eval mode with the running statistics.

Precision, as the configuration states: float32, with the GCN's two
products on bf16-rounded operands (the incoming gradient rounded too) and
float32 sums on an accelerator.  ``dtype=torch.bfloat16`` computes every
part in bfloat16 instead: the control.  Nothing here imports the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.atlas import camera_matrix, geometry

NN_CHUNK_ELEMS = 1 << 28  # (B, rows, M) distance block of the exact search
SCAN_CHUNK_ELEMS = 1 << 26  # (B, tiles, tile, T*S) distance block of the clustered one


# --------------------------------------------------------------- shapes
def encoder_plan(blocks: int, per_block: int, kernel: int, size: int = 256):
    """(specs, selected, channels): the layers that run, as (features,
    stride, simple); the indices whose maps are pooled; their widths."""
    specs, cur, nxt = [(3, 1, True)], 3, 16
    for _ in range(blocks):
        specs.append((nxt, 2, False))
        cur, nxt = nxt, nxt * 2
        specs += [(cur, 1, False)] * (per_block - 1)
    picks = {len(specs) - 1 - (i + 1) * per_block for i in range(3)}
    run, selected, channels = [], [], []
    for e, (feats, stride, simple) in enumerate(specs):
        if size < kernel:
            break
        run.append((feats, stride, simple))
        size = size // stride if stride > 1 else size
        if e in picks:
            selected.append(e)
            channels.append(feats)
    selected.append(len(run) - 1)
    channels.append(run[-1][0])
    return run, selected, channels


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every weight and BatchNorm statistic
    of the model of ``cfg`` (a VisionConfig as a dict)."""
    specs_, _, channels = encoder_plan(cfg["num_cnn_blocks"], cfg["layers_per_block"], cfg["cnn_kernel"])
    fs, k = sum(channels), cfg["cnn_kernel"]
    out = []
    widths = [(63, fs // 4), (fs // 4, fs // 2), (fs // 2, fs)]
    for i, (a, b) in enumerate(widths):
        out += [(f"positional.layers.{i}.weight", (b, a), "dense", a),
                (f"positional.layers.{i}.bias", (b,), "bias", a)]
    out.append(("mask_enc.embed.weight", (4, fs), "embed", 4))
    h, layers = cfg["hidden_gcn_size"], cfg["num_gcn_layers"]
    for g in ("gcn_1", "gcn_2"):
        for i in range(layers):
            a = fs if i == 0 else h
            b = 3 if i == layers - 1 else h
            last = "_out" if i == layers - 1 else ""
            out += [(f"{g}.layers.{i}.weight", (a, b), f"gcn{last}", a),
                    (f"{g}.layers.{i}.bias", (b,), f"gcn{last}_bias", a)]
    for enc in ("global_encoder", "local_encoder"):
        cin, n = 3, 0
        for e, (feats, _, simple) in enumerate(specs_):
            if not simple:
                for stat, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                                   ("running_mean", "bn_mean"), ("running_var", "bn_var")):
                    out.append((f"{enc}.norms.{n}.{stat}", (cin,), kind, cin))
                n += 1
            out += [(f"{enc}.convs.{e}.weight", (feats, cin, k, k), "conv", cin * k * k),
                    (f"{enc}.convs.{e}.bias", (feats,), "bias", cin * k * k)]
            cin = feats
    return out


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def draw_noise(gen: torch.Generator, rows: int, num: int, device) -> tuple:
    """The sampler's random numbers for ``rows`` meshes of ``num`` samples,
    in the order they are drawn: exponential gaps e (rows, num+1), then
    uniforms u and v (rows, num, 1)."""
    kw = dict(generator=gen, device=device)
    e = -torch.log1p(-torch.rand(rows, num + 1, **kw))
    return e, torch.rand(rows, num, 1, **kw), torch.rand(rows, num, 1, **kw)


# --------------------------------------------------------------- search
def exact_nearest(x, y):
    """Index (B, N) of each x's nearest y by exact search: |y|² - 2 x·y in
    blocks of rows, its argmin (the distance itself is taken again from the
    coordinates by the caller)."""
    b, n, _ = x.shape
    rows = max(1, NN_CHUNK_ELEMS // (b * y.shape[1]))
    out = []
    with torch.no_grad():
        yy = y.square().sum(-1)[:, None, :]
        yt = y.transpose(1, 2)
        for s in range(0, n, rows):
            out.append(torch.baddbmm(yy, x[:, s:s + rows], yt, alpha=-2.0).argmin(dim=2))
    return torch.cat(out, dim=1)


def morton_order(pts):
    """Each cloud's points (B, N, 3) ordered along the Z-order curve of a
    1024^3 lattice over the cloud's bounds: (sorted points, order), equal
    codes in index order."""
    lo, hi = pts.amin(dim=1, keepdim=True), pts.amax(dim=1, keepdim=True)
    q = ((pts - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).clamp(0, 1023).to(torch.int64)
    code = torch.zeros(pts.shape[:2], dtype=torch.int64, device=pts.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[..., axis] >> bit) & 1) << (3 * bit + axis)
    order = torch.sort(code, dim=1, stable=True).indices
    return torch.gather(pts, 1, order[..., None].expand(-1, -1, 3)), order


def pad_last(pts, mult: int):
    """The point axis padded to a multiple of ``mult`` by repeating the
    last point."""
    pad = (-pts.shape[1]) % mult
    return torch.cat([pts, pts[:, -1:].expand(-1, pad, -1)], dim=1) if pad else pts


def lower_bound(pts, centres, radii):
    """Least distance from each point (..., P, 3) to any point of each
    chunk (..., K, 3) of radius (..., K): |p - c| - r, (..., P, K)."""
    d = [pts[..., :, None, k] - centres[..., None, :, k] for k in range(3)]
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) - radii[..., None, :]


def clustered_nearest(x, y, search: dict):
    """Index (B, N) of each x's neighbour in y by the clustered search:
    both clouds in Z-order, padded by their last point to whole tiles of
    ``tile`` points; y cut into chunks of ``chunk`` points, each with its
    centre (the mean) and radius (the farthest point from it).  For each
    tile of x, ``anchors`` evenly spaced points rank the chunks by their
    least lower bound and keep the ``candidate_factor * T`` best (T =
    ``chunks_per_tile``, at most the chunks there are); each of the tile's
    points votes for its ``votes`` best candidates by lower bound; the tile scans
    the T most-voted, ties to the chunk whose bound from the tile's mean
    is least (score votes + 1 / (1 + max(bound, 0))), then to the better
    ranked candidate; each point takes the nearest of the scanned points,
    the first in scan order among equals."""
    s, tile = search["chunk"], search["tile"]
    b, n, _ = x.shape
    xs, x_order = morton_order(x)
    ys, y_order = morton_order(y)
    xs, ys = pad_last(xs, tile), pad_last(ys, tile)
    chunks = ys.shape[1] // s
    t = min(search["chunks_per_tile"], chunks)
    k = min(search["candidate_factor"] * t, chunks)
    tiles = xs.shape[1] // tile
    with torch.no_grad():
        y_chunks = ys.reshape(b, chunks, s, 3)
        centres = y_chunks.mean(dim=2)
        radii = torch.sqrt((y_chunks - centres[:, :, None]).square().sum(-1).amax(dim=2))
        x_tiles = xs.reshape(b, tiles, tile, 3)
        means = x_tiles.mean(dim=2)
        rows = torch.arange(b, device=x.device)[:, None, None]
        offsets = torch.arange(s, device=x.device)
        group = max(1, SCAN_CHUNK_ELEMS // (b * tile * t * s))
        found = []
        for g0 in range(0, tiles, group):
            q = x_tiles[:, g0:g0 + group]  # (B, g, tile, 3)
            g = q.shape[1]
            if k < chunks:
                anchors = q[:, :, :: tile // search["anchors"]]
                ranked = lower_bound(anchors, centres[:, None], radii[:, None]).amin(dim=2)
                cand = torch.sort(ranked, dim=-1, stable=True).indices[..., :k]  # (B, g, k)
            else:
                cand = torch.arange(chunks, device=x.device).expand(b, g, chunks)
            cc = centres[rows, cand]  # (B, g, k, 3)
            cr = radii[rows, cand]
            bound = lower_bound(q, cc, cr)  # (B, g, tile, k)
            votes = torch.zeros(b, g, k, device=x.device, dtype=torch.float32)
            for _ in range(min(search["votes"], k)):
                best = bound.argmin(dim=-1)
                votes.scatter_add_(2, best, torch.ones_like(best, dtype=torch.float32))
                bound.scatter_(3, best[..., None], float("inf"))
            near = lower_bound(means[:, g0:g0 + g, None], cc, cr)[:, :, 0]  # (B, g, k)
            score = votes + 1.0 / (1.0 + torch.clamp(near.float(), min=0.0))
            pick = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :t]
            scanned = (torch.gather(cand, 2, pick)[..., None] * s + offsets).reshape(b, g, t * s)
            pts = ys[rows, scanned]  # (B, g, t*s, 3)
            d = [q[..., :, None, a] - pts[:, :, None, :, a] for a in range(3)]
            nearest = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).argmin(dim=-1)  # (B, g, tile)
            found.append(torch.gather(scanned, 2, nearest))
        in_sorted = torch.cat(found, dim=1).reshape(b, -1)[:, :n].clamp(max=y.shape[1] - 1)
        out = torch.empty_like(x_order)
        out.scatter_(1, x_order, torch.gather(y_order, 1, in_sorted))
    return out


# ---------------------------------------------------------------- model
class _Bf16Operands(torch.autograd.Function):
    """``a @ b`` of bf16-rounded operands with float32 sums; the backward
    products round the incoming gradient to bf16 the same way."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.bfloat16().float(), b.bfloat16().float()
        ctx.save_for_backward(a16, b16)
        return torch.matmul(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.bfloat16().float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g16, b16.transpose(-1, -2))
            while ga.dim() > a16.dim():
                ga = ga.sum(0)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a16.transpose(-1, -2), g16)
            while gb.dim() > b16.dim():
                gb = gb.sum(0)
        return ga, gb


class Reference:
    """The model of ``cfg`` on ``device`` in ``dtype``; ``bf16_gcn``
    rounds the GCN's operands to bf16 (the configuration's precision on an
    accelerator; off on the CPU, where the GCN runs in float32)."""

    def __init__(self, cfg: dict, device, dtype=torch.float32, bf16_gcn: bool | None = None):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        # float32 products outside the GCN and the convolutions run without
        # TF32, as the configuration states
        torch.backends.cuda.matmul.allow_tf32 = False
        self.bf16_gcn = (self.device.type == "cuda") if bf16_gcn is None else bf16_gcn
        charts = (1 if cfg["finger"] else 4) * cfg["num_grasps"]
        geo = geometry(charts)
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.atlas = as_t(geo["atlas"]).to(dtype)
        self.original = as_t(geo["original"]).to(dtype)
        self.adj = as_t(geo["adj"]).to(dtype)
        self.faces = as_t(geo["faces"]).long()
        self.camera = as_t(camera_matrix()).to(dtype)
        self.specs, self.selected, _ = encoder_plan(
            cfg["num_cnn_blocks"], cfg["layers_per_block"], cfg["cnn_kernel"])

    # ---- pieces
    def _mm(self, a, b):
        if self.bf16_gcn and self.dtype == torch.float32:
            return _Bf16Operands.apply(a, b)
        return torch.matmul(a, b)

    def _bn(self, p, name, x, train):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = w * torch.rsqrt(var + 1e-5)
        return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def _encoder(self, p, prefix, x, train):
        feats, n, k = [], 0, self.cfg["cnn_kernel"]
        for e, (_, stride, simple) in enumerate(self.specs):
            if not simple:
                x = F.relu(self._bn(p, f"{prefix}.norms.{n}", x, train))
                n += 1
            x = F.conv2d(x, p[f"{prefix}.convs.{e}.weight"], p[f"{prefix}.convs.{e}.bias"],
                         stride=stride, padding=(k - 1) // 2)
            if e in self.selected:
                feats.append(x)
        return feats

    def _positional(self, p, pts, prefix: str = "positional"):
        parts = []
        for i in range(10):
            f = math.pi if i == 0 else 2.0 * math.pi * i
            parts += [torch.sin(f * pts), torch.cos(f * pts)]
        x = torch.cat(parts + [pts], dim=-1)
        for i in range(3):
            x = F.linear(x, p[f"{prefix}.layers.{i}.weight"], p[f"{prefix}.layers.{i}.bias"])
            x = F.relu(x) if i < 2 else x
        return x

    def _pool(self, maps, pts):
        m = self.camera
        hom = pts @ m[:, :3].T + m[:, 3]
        z = torch.where(hom[..., 2] == 0, torch.full_like(hom[..., 2], 0.1), hom[..., 2])
        grid = torch.stack([hom[..., 0] / z / 255.0 * 2 - 1, hom[..., 1] / z / 255.0 * 2 - 1], dim=-1)
        return torch.cat([
            F.grid_sample(f, grid[:, :, None, :], mode="bilinear", padding_mode="zeros",
                          align_corners=True)[..., 0].transpose(1, 2)
            for f in maps], dim=-1)

    def _gcn(self, p, prefix, x, adj, layers: int | None = None):
        layers, cut = layers or self.cfg["num_gcn_layers"], self.cfg["cut"]
        for i in range(layers):
            h = self._mm(x, p[f"{prefix}.layers.{i}.weight"])
            bias = p[f"{prefix}.layers.{i}.bias"]
            if i == layers - 1:
                return self._mm(adj, h) + bias
            k = round(h.shape[-1] * cut)
            x = F.relu(torch.cat([self._mm(adj, h[..., :k]) + bias[:k], h[..., k:]], dim=-1))

    def deform(self, p, img, touch_charts, train: bool):
        """Vertices (B, V, 3) of the deformed atlas for images (B, H, W, 3)
        and touch slots (B, grasps, fingers, 25, 4) = xyz | mask code."""
        b, vc = img.shape[0], self.atlas.shape[0]
        x = img.permute(0, 3, 1, 2)
        gfeats = self._encoder(p, "global_encoder", x, train)
        lfeats = self._encoder(p, "local_encoder", x, train)
        info = touch_charts.reshape(b, -1, 4)
        embed = p["mask_enc.embed.weight"]
        verts = self.atlas[None].expand(b, -1, -1)
        vmask = torch.full((b, vc), 3, dtype=torch.long, device=self.device)
        feats = self._positional(p, verts) + embed[vmask] + self._pool(gfeats, verts)
        verts = verts + self._gcn(p, "gcn_1", feats, self.original)
        verts = torch.cat([verts, info[..., :3]], dim=1)
        codes = embed[torch.cat([vmask, info[..., 3].long()], dim=1)]
        for _ in range(2):
            feats = self._positional(p, verts) + codes + self._pool(lfeats, verts)
            update = self._gcn(p, "gcn_2", feats, self.adj)
            verts = torch.cat([verts[:, :vc] + update[:, :vc], verts[:, vc:]], dim=1)
        return verts

    # ---- sampler and loss
    def sample(self, verts, draws):
        """Area-weighted surface samples (B, num, 3) from the draws
        (e (B, num+1) exponential gaps, u, v (B, num, 1) uniforms): sorted
        uniforms u_(i) = Σ_{j<=i} e_j / Σ_j e_j pick the faces by the
        inverse area CDF, then barycentric weights 1 - √u, √u(1 - v), √u v."""
        e, u, v = (t.to(self.dtype) for t in draws)
        faces = self.faces
        with torch.no_grad():
            c = verts[:, faces]  # (B, F, 3 corners, 3)
            areas = 0.5 * torch.linalg.vector_norm(
                torch.linalg.cross(c[:, :, 1] - c[:, :, 0], c[:, :, 2] - c[:, :, 0], dim=-1), dim=-1)
            areas = torch.nan_to_num(areas, nan=0.0).abs()
            total = areas.sum(dim=1, keepdim=True)
            probs = torch.where(total > 0, areas / total.clamp(min=1e-30),
                                torch.full_like(areas, 1.0 / areas.shape[1]))
            cdf = torch.cumsum(probs, dim=1)
            n = e.shape[1] - 1
            ce = torch.cumsum(e, dim=1)
            sorted_u = ce[:, :n] / ce[:, n:]
            idx = torch.searchsorted(cdf.contiguous(), sorted_u.contiguous(), right=True)
            idx = idx.clamp(max=faces.shape[0] - 1)
        corners = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
        picked = [torch.gather(cn, 1, idx[..., None].expand(-1, -1, 3)) for cn in corners]
        su = torch.sqrt(u)
        return (1 - su) * picked[0] + su * (1 - v) * picked[1] + su * v * picked[2]

    def nearest(self, x, y):
        """Index (B, N) of each x's neighbour in y, by the search the
        configuration states."""
        if self.cfg.get("loss_nn") == "clustered":
            return clustered_nearest(x, y, self.cfg["clustered_search"])
        return exact_nearest(x, y)
    def chamfer(self, x, y):
        """(B,) symmetric Chamfer distance, squared, mean over points."""
        ny = torch.gather(y, 1, self.nearest(x, y)[..., None].expand(-1, -1, 3))
        nx = torch.gather(x, 1, self.nearest(y, x)[..., None].expand(-1, -1, 3))
        return (x - ny).square().sum(-1).mean(1) + (y - nx).square().sum(-1).mean(1)

    def mesh_distances(self, p, batch, draws, train: bool):
        """((B,) 3-repeat Chamfer distance of each row's mesh to its cloud,
        (B, V, 3) the meshes)."""
        img = batch["img"].to(self.dtype)
        verts = self.deform(p, img, batch["touch_charts"].to(self.dtype), train)
        num, b = self.cfg["number_points"], img.shape[0]
        pts = self.sample(verts, draws)
        repeat = pts.shape[1] // num
        preds = torch.cat(torch.split(pts, num, dim=1), dim=0)
        gt = batch["gt_points"].to(self.dtype).repeat(repeat, 1, 1)
        return self.chamfer(preds, gt).reshape(repeat, b).mean(dim=0), verts

    def row_distances(self, p, batch, draws, train: bool):
        return self.mesh_distances(p, batch, draws, train)[0]

    def loss(self, p, batch, draws, train: bool, fault: str | None = None):
        rows = self.row_distances(p, batch, draws, train)
        if fault == "row0x2":
            rows = torch.cat([2 * rows[:1], rows[1:]])
        return self.cfg["loss_coeff"] * rows.mean()


def cast(weights: dict, dtype, device) -> dict:
    return {k: v.detach().to(device=device, dtype=dtype).clone() for k, v in weights.items()}


def half_rows(batch: dict, draws: tuple) -> tuple[dict, tuple]:
    h = next(iter(batch.values())).shape[0] // 2
    return {k: v[:h] for k, v in batch.items()}, tuple(t[:h] for t in draws)


def train_steps(ref: Reference, weights: dict, batches: list, draws: list, lr: float,
                fault: str | None = None) -> dict:
    """Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected) steps from
    ``weights`` over ``batches``: each step's loss, each parameter's first
    gradient norm and its change's norm over all the steps.  ``fault``:
    "half" takes the first half of each batch's rows, "row0x2" doubles the
    first row's distance."""
    p = cast(weights, ref.dtype, ref.device)
    names = [k for k in p if is_parameter(k)]
    start = {k: p[k].float().clone() for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, first = [], None
    for t, (batch, dr) in enumerate(zip(batches, draws), 1):
        if fault == "half":
            batch, dr = half_rows(batch, dr)
        for k in names:
            p[k].requires_grad_(True)
        loss = ref.loss(p, batch, dr, train=True, fault=fault if fault == "row0x2" else None)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g.float())) for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                p[k] = p[k].detach()
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v[k].sqrt() / math.sqrt(1 - 0.999 ** t)).add_(1e-8)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - 0.9 ** t))
        del loss, grads
    change = {k: float(torch.linalg.vector_norm(p[k].float() - start[k])) for k in names}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def eval_losses(ref: Reference, weights: dict, batches: list, draws: list,
                fault: str | None = None) -> list[float]:
    p = cast(weights, ref.dtype, ref.device)
    out = []
    with torch.no_grad():
        for batch, dr in zip(batches, draws):
            if fault == "half":
                batch, dr = half_rows(batch, dr)
            out.append(float(ref.loss(p, batch, dr, train=False,
                                      fault=fault if fault == "row0x2" else None)))
    return out
