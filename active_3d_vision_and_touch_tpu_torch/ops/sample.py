"""Differentiable area-weighted surface sampling of a batch of meshes.

Port of the JAX package's ``ops/sample.py``:

- face areas from the cross product, outside the autograd graph;
- face selection by inverse CDF over *sorted* uniforms, drawn without a
  sort as normalized cumulative sums of exponential gaps, so the face ids
  come out monotone per row;
- barycentric weights w0 = 1 - sqrt(u), w1 = sqrt(u)(1 - v), w2 = sqrt(u) v;
- :class:`_Interpolate`, whose backward sums each face's run of the sorted
  sample stream with the sorted segment sum of :mod:`ops.segsum` (one launch
  of its kernel on a CUDA tensor: the face ids are non-decreasing per row by
  construction, so nothing is sorted), and only then adds the per-face sums
  into the vertices, instead of scattering every sample.

The random numbers are drawn apart from their use
(:func:`draw_sample_noise`), so a test can hand the same numpy-made draws to
this sampler and to the JAX one: torch generators and JAX keys never give
the same bits.
"""

from __future__ import annotations

import torch

from active_3d_vision_and_touch_tpu_torch.ops.segsum import segment_accumulate_sorted


def face_areas(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (F, 3) → (B, F) triangle areas."""
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    cross = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return 0.5 * torch.linalg.vector_norm(cross, dim=-1)


def _inverse_cdf_sorted(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Exact ``#{f : cdf_f <= u_j}`` for per-row SORTED queries ``u``.

    With u ascending, face f covers the query positions i >= N_f where
    N_f = #{j : u_j < cdf_f}: one (B, F) binary search into the sample axis,
    ones scattered at the run starts, then a cumsum over the sample axis.
    """
    b, n = u.shape
    counts = torch.searchsorted(u.contiguous(), cdf.contiguous(), side="left")
    z = torch.zeros(b, n + 1, dtype=torch.int64, device=u.device)
    z.scatter_add_(1, counts, torch.ones_like(counts))
    return torch.cumsum(z, dim=1)[:, :n]


def _sorted_uniforms(e: torch.Tensor) -> torch.Tensor:
    """(B, n+1) exponential gaps → (B, n) sorted uniforms
    u_(i) = Σ_{j<=i} E_j / Σ_{j<=n} E_j (uniform order statistics)."""
    n = e.shape[1] - 1
    c = torch.cumsum(e, dim=1)
    return c[:, :n] / c[:, n:]


def draw_sample_noise(
    b: int,
    num: int,
    generator: torch.Generator | None = None,
    device=None,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sampler's random numbers: exponential gaps ``e`` (B, num+1) for
    the face draw and uniforms ``u``, ``v`` (B, num, 1) for the barycentric
    coordinates."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    e = -torch.log1p(-torch.rand(b, num + 1, **kw))
    u = torch.rand(b, num, 1, **kw)
    v = torch.rand(b, num, 1, **kw)
    return e, u, v


def _gather_corners(verts: torch.Tensor, idx: torch.Tensor, faces: torch.Tensor):
    """(B, num, 3 corners, 3 xyz) corner positions of each sampled face."""
    b = verts.shape[0]
    table = verts[:, faces.reshape(-1)].reshape(b, faces.shape[0], 9)
    rows = torch.gather(table, 1, idx[..., None].expand(-1, -1, 9))
    return rows.reshape(b, idx.shape[1], 3, 3)


class _Interpolate(torch.autograd.Function):
    """pts_i = Σ_k w_i[k] · verts[faces[idx_i], k] for per-row SORTED idx."""

    @staticmethod
    def forward(ctx, verts, idx, w, faces):
        pts = _gather_corners(verts, idx, faces)  # (B, num, 3, 3)
        ctx.save_for_backward(pts, idx, w, faces)
        ctx.num_verts = verts.shape[1]
        return torch.sum(w[..., None] * pts, dim=2)

    @staticmethod
    def backward(ctx, g):
        pts, idx, w, faces = ctx.saved_tensors
        b = g.shape[0]
        f = faces.shape[0]
        # per face f and corner k: seg[k, b, f] = Σ_{i: idx_i = f} w_i[k] · g_i.
        # idx is sorted per row, so this is a sorted segment sum; the three
        # corners fold onto the batch, corner k in rows k*B .. (k+1)*B
        num = idx.shape[1]
        ids = idx.to(torch.int32).repeat(3, 1)  # (3B, num)
        vals = (w.permute(2, 0, 1)[..., None] * g[None]).reshape(3 * b, num, 3)
        seg = segment_accumulate_sorted(ids, vals.float().contiguous(), f)
        seg = seg.to(g.dtype).reshape(3, b, f, 3)
        dverts = g.new_zeros(b, ctx.num_verts, 3)
        for k in range(3):
            dverts.index_add_(1, faces[:, k], seg[k])
        dw = torch.sum(g[:, :, None, :] * pts, dim=-1)
        return dverts, None, dw, None


def _interpolate(verts, idx, w, faces):
    return _Interpolate.apply(verts, idx, w, faces)


def sample_faces(
    verts: torch.Tensor, faces: torch.Tensor, e: torch.Tensor
) -> torch.Tensor:
    """Area-weighted face ids (B, num), non-decreasing per row, from the
    exponential gaps ``e`` (B, num+1)."""
    with torch.no_grad():
        areas = face_areas(verts, faces)
        areas = torch.where(torch.isnan(areas), torch.zeros_like(areas), areas.abs())
        total = areas.sum(dim=1, keepdim=True)
        probs = torch.where(
            total > 0, areas / torch.clamp(total, min=1e-30), torch.zeros_like(areas)
        )
        # degenerate all-zero-area mesh: fall back to uniform
        probs = torch.where(total > 0, probs, torch.full_like(probs, 1.0 / probs.shape[1]))
        cdf = torch.cumsum(probs, dim=1)
        idx = _inverse_cdf_sorted(cdf, _sorted_uniforms(e))
        return torch.clamp(idx, 0, faces.shape[0] - 1)


def batch_sample(
    verts: torch.Tensor,
    faces: torch.Tensor,
    num: int = 10000,
    generator: torch.Generator | None = None,
    draws: tuple | None = None,
    shard: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Sample ``num`` points per mesh, proportional to face area.

    verts: (B, V, 3) float, faces: (F, 3) int64 (shared across the batch) →
    (B, num, 3), differentiable in ``verts``.  ``draws`` = (e, u, v) from
    :func:`draw_sample_noise` replaces the draw from ``generator``.
    ``shard=(index, count)``: ``verts`` is rows ``index * B`` to
    ``(index + 1) * B`` of a global batch of ``count * B`` meshes, which
    ``generator`` draws for whole, so the points do not depend on
    ``count``.
    """
    b = verts.shape[0]
    if draws is None and shard is None:
        draws = draw_sample_noise(b, num, generator, verts.device, verts.dtype)
    elif draws is None:
        index, count = shard
        noise = draw_sample_noise(b * count, num, generator, verts.device, verts.dtype)
        draws = tuple(t[index * b : (index + 1) * b] for t in noise)
    e, u, v = draws
    idx = sample_faces(verts, faces, e)
    su = torch.sqrt(u)
    w = torch.cat([1.0 - su, su * (1.0 - v), su * v], dim=-1)
    return _interpolate(verts, idx, w, faces)
