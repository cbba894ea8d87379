"""Procedural object meshes.

The port's copy of the JAX package's ``data/primitives.py``.

The reference trains on a ~26k-object subset of the ABC CAD dataset
downloaded at setup time (``download_data.sh``); in this framework objects
can also be *generated*: watertight procedural shapes (deformed spheres,
rounded boxes, superquadrics) with matched scale/centering, so the full
pipeline — simulation, dataset dumps, training, policies — runs with zero
external downloads.  Real meshes drop in through the same
``scale_points`` preprocessing (``core.mesh.scale_points``).
"""

from __future__ import annotations

import numpy as np

from active_3d_vision_and_touch_tpu_torch.core.mesh import Mesh, scale_points


def icosphere(subdivisions: int = 3) -> Mesh:
    """Unit icosphere by repeated edge-midpoint subdivision."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces)
    return Mesh(verts.astype(np.float32), faces.astype(np.int32))


def _radial_field(directions: np.ndarray, rng: np.random.Generator, bumps: int):
    """Smooth positive radial modulation from random spherical gaussians."""
    centers = rng.normal(size=(bumps, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amps = rng.uniform(-0.55, 0.8, size=bumps)
    widths = rng.uniform(2.0, 8.0, size=bumps)
    cos = directions @ centers.T  # (V, bumps)
    field = 1.0 + (amps * np.exp(widths * (cos - 1.0))).sum(axis=1)
    return np.maximum(field, 0.3)


def bumpy_sphere(rng: np.random.Generator, subdivisions: int = 3) -> Mesh:
    base = icosphere(subdivisions)
    d = base.verts / np.linalg.norm(base.verts, axis=1, keepdims=True)
    r = _radial_field(d, rng, bumps=int(rng.integers(3, 12)))
    verts = d * r[:, None]
    verts = verts * rng.uniform(0.5, 1.0, size=(1, 3))  # anisotropic squash
    return Mesh(verts.astype(np.float32), base.faces)


def superquadric(
    rng: np.random.Generator, resolution: int = 28
) -> Mesh:
    """Closed superquadric surface mesh (lat/long grid, poles welded)."""
    e1 = float(rng.uniform(0.2, 2.2))
    e2 = float(rng.uniform(0.2, 2.2))
    ax = rng.uniform(0.25, 1.0, size=3)

    def sgnpow(x, p):
        return np.sign(x) * np.abs(x) ** p

    eta = np.linspace(-np.pi / 2, np.pi / 2, resolution)
    omega = np.linspace(-np.pi, np.pi, resolution, endpoint=False)
    E, O = np.meshgrid(eta, omega, indexing="ij")
    x = ax[0] * sgnpow(np.cos(E), e1) * sgnpow(np.cos(O), e2)
    y = ax[1] * sgnpow(np.cos(E), e1) * sgnpow(np.sin(O), e2)
    z = ax[2] * sgnpow(np.sin(E), e1)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    faces = []
    for i in range(resolution - 1):
        for j in range(resolution):
            j2 = (j + 1) % resolution
            a = i * resolution + j
            b = i * resolution + j2
            c = (i + 1) * resolution + j
            d = (i + 1) * resolution + j2
            faces += [[a, b, c], [b, d, c]]
    return Mesh(verts.astype(np.float32), np.asarray(faces, np.int32))


def rounded_box(rng: np.random.Generator, subdivisions: int = 3) -> Mesh:
    """Sphere pushed toward a box by an L-p norm (p in [3, 10])."""
    base = icosphere(subdivisions)
    p = float(rng.uniform(3.0, 10.0))
    d = base.verts / np.linalg.norm(base.verts, axis=1, keepdims=True)
    lp = (np.abs(d) ** p).sum(axis=1) ** (1.0 / p)
    verts = d / lp[:, None] * rng.uniform(0.5, 1.0, size=(1, 3))
    return Mesh(verts.astype(np.float32), base.faces)


def torus(rng: np.random.Generator, resolution: int = 24) -> Mesh:
    """Torus with randomized radii (gives the dataset a genus-1 shape —
    concavity + a hole, which the convex-hull-trained policies must probe)."""
    major = float(rng.uniform(0.6, 1.0))
    minor = float(rng.uniform(0.15, 0.45)) * major
    u = np.linspace(0, 2 * np.pi, resolution, endpoint=False)
    v = np.linspace(0, 2 * np.pi, resolution, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = (major + minor * np.cos(vv)) * np.sin(uu)
    z = minor * np.sin(vv)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    faces = []
    for i in range(resolution):
        for j in range(resolution):
            i2, j2 = (i + 1) % resolution, (j + 1) % resolution
            a, b = i * resolution + j, i * resolution + j2
            c, d = i2 * resolution + j, i2 * resolution + j2
            faces += [[a, b, c], [b, d, c]]
    squash = rng.uniform(0.6, 1.0, size=(1, 3))
    return Mesh((verts * squash).astype(np.float32), np.asarray(faces, np.int32))


def blob_union(rng: np.random.Generator) -> Mesh:
    """Union of two offset deformed blobs (triangle soup — the voxel-carve
    point extraction, hull grasping, and z-buffer rendering all accept
    non-watertight unions)."""
    a = bumpy_sphere(rng, subdivisions=2)
    b = bumpy_sphere(rng, subdivisions=2)
    offset = rng.uniform(-0.7, 0.7, size=3)
    scale_b = float(rng.uniform(0.4, 0.9))
    verts = np.concatenate([a.verts, b.verts * scale_b + offset.astype(np.float32)])
    faces = np.concatenate([a.faces, b.faces + a.num_verts])
    return Mesh(verts, faces)


GENERATORS = (bumpy_sphere, superquadric, rounded_box, torus, blob_union)


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    return R.random(random_state=np.random.RandomState(rng.integers(2**31))).as_matrix()


def _smooth_part(rng: np.random.Generator) -> Mesh:
    """Locally smooth primitive (no bump fields): the chart atlas can
    represent these near-exactly, keeping the reconstruction floor low."""
    k = int(rng.integers(3))
    if k == 0:
        return superquadric(rng, resolution=20)
    if k == 1:
        return torus(rng, resolution=18)
    return rounded_box(rng, subdivisions=2)


def _stretched(verts: np.ndarray, rng: np.random.Generator, lo: float, hi: float, smax: float) -> np.ndarray:
    """Random anisotropic scale with one strongly stretched axis — the
    eccentricity that drives the distribution's gross-shape entropy."""
    scale = rng.uniform(lo, hi, size=(1, 3))
    stretch = np.ones(3)
    stretch[int(rng.integers(3))] = rng.uniform(1.0, smax)
    return (verts * (scale * stretch)).astype(np.float32)


def eccentric_single(rng: np.random.Generator) -> Mesh:
    """One smooth primitive, strongly stretched: measured medoid-prior CD
    4.6e-3 vs 2.5e-3 for the round-1 families (scripts in the 'generator
    entropy' commit) — the widest-spread family in the mixture."""
    part = _smooth_part(rng)
    verts = part.verts @ _random_rotation(rng).T.astype(np.float32)
    return Mesh(_stretched(verts, rng, 0.3, 1.0, 4.0), part.faces)


def composed_object(rng: np.random.Generator) -> Mesh:
    """Union of 2-5 smooth, stretched parts, each anchored just beyond a
    random surface vertex of the assembly so the union stays one connected
    graspable body (arms, L-shapes, dumbbells, lobed parts — CAD-like
    gross-shape variance a global mean-shape prior cannot absorb)."""
    k = int(rng.integers(2, 6))
    part = _smooth_part(rng)
    verts = part.verts @ _random_rotation(rng).T.astype(np.float32)
    verts = _stretched(verts, rng, 0.3, 1.0, 3.0)
    faces = part.faces
    for _ in range(k - 1):
        part = _smooth_part(rng)
        pv = part.verts @ _random_rotation(rng).T.astype(np.float32)
        pv = _stretched(pv, rng, 0.2, 0.8, 3.0)
        anchor = verts[int(rng.integers(len(verts)))]
        # push the part's center slightly past the surface: lumpy unions
        # with real protrusions instead of interpenetrating near-spheres
        center = anchor * float(rng.uniform(0.9, 1.4))
        faces = np.concatenate([faces, part.faces + len(verts)])
        verts = np.concatenate([verts, (pv + center).astype(np.float32)])
    return Mesh(verts, faces)


def _warp(verts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random global nonlinear deformation: twist, taper, or shear along a
    random axis.  Breaks the residual symmetry/axis-alignment statistics a
    deformation prior latches onto."""
    frame = _random_rotation(rng).astype(np.float32)
    v = verts @ frame.T  # warp axis = local z
    z = v[:, 2]
    span = max(z.max() - z.min(), 1e-6)
    t = (z - z.min()) / span  # 0..1 along the axis
    kind = int(rng.integers(3))
    if kind == 0:  # twist about z
        ang = float(rng.uniform(-1.4, 1.4)) * t
        c, s = np.cos(ang), np.sin(ang)
        v = np.stack([v[:, 0] * c - v[:, 1] * s, v[:, 0] * s + v[:, 1] * c, z], 1)
    elif kind == 1:  # taper xy with z
        f = 1.0 + (float(rng.uniform(0.5, 1.8)) - 1.0) * t
        v = np.stack([v[:, 0] * f, v[:, 1] * f, z], 1)
    else:  # shear x by z
        v = np.stack([v[:, 0] + float(rng.uniform(-0.8, 0.8)) * z, v[:, 1], z], 1)
    return (v @ frame).astype(np.float32)


def lobed_blob(
    rng: np.random.Generator,
    subdivisions: int = 3,
    amp_gain: float = 1.0,
    width_gain: float = 1.0,
) -> Mesh:
    """Sphere with few LARGE-amplitude, broad radial lobes, anisotropically
    squashed and moderately stretched.  The round-3 touch-dominance family:
    the per-family diagnostic on the round-2 model
    (results_campaign/touch_value_by_family.json) showed big-lobe shapes
    carry ~4x the touch signal of stretched smooth primitives (63% vs 90%
    CD remaining after 5 grasps) — lobes are both unhedgeable by a mean
    -shape prior AND locally revealed by a single grasp.

    ``amp_gain``/``width_gain`` (v4) scale the lobe amplitude/angular
    frequency so the caller can draw *per-object* surface statistics: a
    mean-shape prior must hedge across objects that range from near-spheres
    to deeply lobed, while one grasp reveals the object's own amplitude
    band."""
    base = icosphere(subdivisions)
    d = base.verts / np.linalg.norm(base.verts, axis=1, keepdims=True)
    k = int(rng.integers(2, 11))
    centers = rng.normal(size=(k, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amps = rng.uniform(-0.5, 1.5, size=k) * amp_gain
    widths = rng.uniform(1.2, 5.0, size=k) * width_gain
    cos = d @ centers.T
    r = np.maximum(1.0 + (amps * np.exp(widths * (cos - 1.0))).sum(axis=1), 0.25)
    verts = d * r[:, None]
    verts = verts * rng.uniform(0.45, 1.0, size=(1, 3))
    stretch = np.ones(3)
    stretch[int(rng.integers(3))] = rng.uniform(1.0, 2.2)
    return Mesh((verts * stretch).astype(np.float32), base.faces)


def multi_blob(
    rng: np.random.Generator, amp_gain: float = 1.0, width_gain: float = 1.0
) -> Mesh:
    """Union of 2-4 overlapping lobed blobs — one connected lumpy mass
    (blob_union generalized; kept overlapping rather than arm-like: the
    protruding-arm compositions measured the WORST touch value)."""
    parts = []
    k = int(rng.integers(2, 5))
    verts, faces = None, None
    for j in range(k):
        p = lobed_blob(rng, subdivisions=2, amp_gain=amp_gain, width_gain=width_gain)
        pv = p.verts * float(rng.uniform(0.45, 1.0 if j else 1.2))
        if verts is None:
            verts, faces = pv, p.faces
        else:
            offset = rng.uniform(-0.8, 0.8, size=3).astype(np.float32)
            faces = np.concatenate([faces, p.faces + len(verts)])
            verts = np.concatenate([verts, pv + offset])
    return Mesh(verts.astype(np.float32), faces)


def box_mesh(half_extents) -> Mesh:
    """Axis-aligned box (12 triangles, outward winding)."""
    h = np.asarray(half_extents, np.float32)
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.float32,
    )  # index bit order: x*4 + y*2 + z
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return Mesh(corners * h, faces)


def slab_assembly(rng: np.random.Generator) -> Mesh:
    """Union of 1-4 thin slabs/beams crossing near the origin — the
    CAD-bracket entropy class (v4).  Thin surfaces at random orientations
    are expensive for a hedged mean-shape prior to cover under symmetric
    Chamfer (mass spent near one slab is wrong for every other object),
    yet a single contact reveals the local plane exactly — prior-badness
    that is both large and *touch-recoverable*, and spatially localized so
    WHICH grasp is taken matters (policy separation)."""
    k = int(rng.integers(1, 5))
    verts, faces = None, None
    for j in range(k):
        h = rng.uniform(0.3, 1.2, size=3)
        thin_axes = [int(rng.integers(3))]
        if rng.uniform() < 0.35:  # beams: thin in two axes
            thin_axes.append((thin_axes[0] + 1 + int(rng.integers(2))) % 3)
        for a in thin_axes:
            h[a] = rng.uniform(0.05, 0.12)
        part = box_mesh(h)
        pv = part.verts @ _random_rotation(rng).T.astype(np.float32)
        if verts is None:
            verts, faces = pv, part.faces
        else:
            offset = rng.uniform(-0.45, 0.45, size=3).astype(np.float32)
            faces = np.concatenate([faces, part.faces + len(verts)])
            verts = np.concatenate([verts, pv + offset])
    return Mesh(verts.astype(np.float32), faces)


def shell_bowl(
    rng: np.random.Generator, amp_gain: float = 1.0, width_gain: float = 1.0
) -> Mesh:
    """Open shell: a lobed blob with a planar cap of faces removed.

    EXPERIMENTAL / NOT IN THE SHIPPED v4 MIXTURE: tried during the v4
    distribution design and rejected (ROADMAP round-3 ledger — shells
    diluted hedged-proxy entropy and the opening direction is hard to pin
    from contacts).  Kept only as a generator for future distribution
    experiments; ``random_object`` never calls it."""
    base = lobed_blob(rng, subdivisions=3, amp_gain=0.6 * amp_gain,
                      width_gain=width_gain)
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    proj = base.verts[base.faces].mean(axis=1) @ n.astype(np.float32)
    keep_frac = float(rng.uniform(0.5, 0.8))
    keep = proj <= np.quantile(proj, keep_frac)
    faces = base.faces[keep]
    used = np.unique(faces)
    remap = np.full(base.num_verts, -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return Mesh(base.verts[used], remap[faces])


def random_object(seed: int, scale: float = 3.1, version: int = 3) -> Mesh:
    """Deterministic procedural object, preprocessed like dataset objects
    (centered; for version<=3 max extent = 1/scale — reference
    ``data_making.py:76-95``.  version>=4 multiplies a per-axis scale of
    U(0.45, 2.2) AFTER normalization, so extents range up to 2.2/scale
    per axis by design — see the v4 notes below).

    Distribution design (v3): the reference trains on ABC CAD parts whose
    gross-shape entropy makes an input-free prior ~4-6x worse than the
    trained-with-touch result (BASELINE.md T_G ratios) — that headroom is
    what active touch selection optimizes.  The round-2 mixture leaned on
    stretched smooth primitives and multi-part compositions; the per-family
    diagnostic (results_campaign/touch_value_by_family.json) measured those
    at 89.5% / 93.5% CD remaining after 5 grasps while the big-lobe legacy
    family reached 63.1% with the highest prior CD — touch-valuable entropy
    comes from broad radial lobes, not eccentricity or part placement.  v3
    therefore mixes 55% lobed blobs, 25% overlapping multi-blob unions, 10%
    stretched smooth singles, 10% round-1 families, through 0-1 nonlinear
    warps and a random global rotation.

    v4 (round-3, ROADMAP round-4 #1) attacks the two reasons v3's trained
    0-grasp prior stayed good (85% CD remaining vs the reference's 26%):

      * **normalization erased gross scale** — every object spanned the
        same extent, so a hedged ellipsoid covered the whole distribution.
        v4 draws a per-object per-axis scale from U(0.45, 2.2) AFTER
        ``scale_points``: size/aspect is pinned exactly by the first
        grasp's ground-truth chart anchors but only weakly visible from
        the fixed monocular camera (and clipped for the largest objects),
        so it feeds both the T and V&T regimes.
      * **blob surfaces are hedgeable** — all v3 families keep their
        surface near an ellipsoid shell, which a mean-shape prior covers
        cheaply under squared Chamfer.  v4 adds a 30% ``slab_assembly``
        family (thin crossing plates/beams — the ABC bracket class) whose
        thin surfaces at random orientations are expensive to hedge and
        *localized*, so which grasp is chosen matters (policy separation),
        plus per-object lobe amplitude/frequency gains (amp U(0.25, 1.7),
        angular width exp(U(ln 0.6, ln 2.2))) making surface statistics an
        object property one touch reveals.

    Gate before training: scripts/proxy_hedged.py optimizes the best
    unconditional point cloud (the true 0-grasp floor) and requires a
    ≥2.5x jump over the v3 calibration value.
    """
    rng = np.random.default_rng(seed)
    u = rng.uniform()
    if version >= 4:
        amp_gain = float(rng.uniform(0.25, 1.7))
        width_gain = float(np.exp(rng.uniform(np.log(0.6), np.log(2.2))))
        if u < 0.35:
            mesh = lobed_blob(rng, amp_gain=amp_gain, width_gain=width_gain)
        elif u < 0.50:
            mesh = multi_blob(rng, amp_gain=amp_gain, width_gain=width_gain)
        elif u < 0.80:
            mesh = slab_assembly(rng)
        elif u < 0.90:
            mesh = eccentric_single(rng)
        else:
            mesh = GENERATORS[int(rng.integers(len(GENERATORS)))](rng)
    elif u < 0.55:
        mesh = lobed_blob(rng)
    elif u < 0.80:
        mesh = multi_blob(rng)
    elif u < 0.90:
        mesh = eccentric_single(rng)
    else:
        mesh = GENERATORS[int(rng.integers(len(GENERATORS)))](rng)
    verts = mesh.verts
    for _ in range(int(rng.integers(0, 2))):
        verts = _warp(verts, rng)
    verts = verts @ _random_rotation(rng).T.astype(np.float32)
    verts = scale_points(verts, scale=scale)
    if version >= 4:
        axis_scale = rng.uniform(0.45, 2.2, size=(1, 3))
        verts = (verts * axis_scale).astype(np.float32)
    return Mesh(verts, mesh.faces)
