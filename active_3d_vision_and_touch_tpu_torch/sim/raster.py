"""Host-side triangle rasterizer: a C++ library and its plain numpy version.

The port's copy of the JAX package's ``sim/raster.py``, over its own copy
of ``csrc/raster.cpp``.  ``g++`` compiles the source at its first use, with
the flags of the JAX package's ``csrc/Makefile``, into a shared library
under ``build/host/`` named after a hash of the source, the flags and the
host's CPU model (``-march=native`` ties the library to the CPU it was built
on), and ``ctypes`` binds it.  The build writes a temporary file and renames
it into place, so processes building at once never load half a library.

There is no silent fallback: the default route (``use_native=None`` or
``True``) uses the library and raises with the compiler's messages if it
does not build; only ``use_native=False`` takes the numpy version, the
plain reference the tests hold the library against.

Conventions: camera rotation is a 3x3 world→camera matrix whose rows are
(right, down, forward); depth maps are (H, W) float32 camera-z with 0
meaning "no geometry"; face-id maps are int32 with -1 for misses.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "raster.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_LOCK = threading.Lock()
_LIBS: dict = {}

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(source: Path = SOURCE) -> Path:
    """Where the library of ``source`` is built on this host."""
    digest = hashlib.sha256(
        Path(source).read_bytes()
        + " ".join(CXX_FLAGS).encode()
        + _cpu_model().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library exists; raises with the
    compiler's output if the build fails."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library():
    """The bound library of :data:`SOURCE`, built at the first call."""
    with _LOCK:
        lib = _LIBS.get(SOURCE)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(SOURCE)))
            lib.rasterize_depth.argtypes = [
                _F32P, ctypes.c_int, _I32P, ctypes.c_int, _F32P, _F32P,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, _F32P, _I32P,
            ]
            lib.rasterize_depth.restype = None
            lib.ray_mesh_hits.argtypes = [
                _F32P, ctypes.c_int, _I32P, ctypes.c_int, _F32P, _F32P, _F32P, _I32P,
                ctypes.c_int,
            ]
            lib.ray_mesh_hits.restype = ctypes.c_int
            _LIBS[SOURCE] = lib
        return lib


def focal_from_yfov(yfov_deg: float, height: int) -> float:
    return (height / 2.0) / math.tan(math.radians(yfov_deg) / 2.0)


def _as_f32(x):
    return np.ascontiguousarray(x, np.float32)


def rasterize_depth(
    verts: np.ndarray,
    faces: np.ndarray,
    cam_pos: np.ndarray,
    cam_rot: np.ndarray,
    focal: float,
    width: int,
    height: int,
    znear: float = 1e-4,
    use_native: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (depth (H,W) f32, face_id (H,W) i32): the library, or with
    ``use_native=False`` the numpy version."""
    verts = _as_f32(verts).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    cam_pos = _as_f32(cam_pos).reshape(3)
    cam_rot = _as_f32(cam_rot).reshape(3, 3)
    if use_native is False:
        return _rasterize_numpy(verts, faces, cam_pos, cam_rot, focal, width, height, znear)
    lib = load_library()
    depth = np.zeros((height, width), np.float32)
    face_id = np.full((height, width), -1, np.int32)
    lib.rasterize_depth(
        verts.ctypes.data_as(_F32P),
        len(verts),
        faces.ctypes.data_as(_I32P),
        len(faces),
        cam_pos.ctypes.data_as(_F32P),
        cam_rot.ctypes.data_as(_F32P),
        ctypes.c_float(focal),
        ctypes.c_float(focal),
        ctypes.c_float(width / 2.0),
        ctypes.c_float(height / 2.0),
        width,
        height,
        ctypes.c_float(znear),
        depth.ctypes.data_as(_F32P),
        face_id.ctypes.data_as(_I32P),
    )
    return depth, face_id


def _rasterize_numpy(verts, faces, cam_pos, cam_rot, focal, width, height, znear):
    cam = (verts - cam_pos) @ cam_rot.T  # (V, 3)
    tri = cam[faces]  # (F, 3, 3)
    ok = np.all(tri[:, :, 2] > znear, axis=1)
    tri = tri[ok]
    ids = np.nonzero(ok)[0].astype(np.int32)
    depth = np.zeros((height, width), np.float32)
    face_id = np.full((height, width), -1, np.int32)
    if len(tri) == 0:
        return depth, face_id

    inv_z = 1.0 / tri[:, :, 2]
    xs = focal * tri[:, :, 0] * inv_z + width / 2.0
    ys = focal * tri[:, :, 1] * inv_z + height / 2.0

    # screen-space cull
    inside = (
        (xs.max(1) >= 0)
        & (xs.min(1) <= width - 1)
        & (ys.max(1) >= 0)
        & (ys.min(1) <= height - 1)
    )
    xs, ys, inv_z, ids = xs[inside], ys[inside], inv_z[inside], ids[inside]

    for f in range(len(ids)):
        ax, bx, cx = xs[f]
        ay, by, cy = ys[f]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if abs(area) < 1e-12:
            continue
        minx = max(0, int(np.floor(min(ax, bx, cx))))
        maxx = min(width - 1, int(np.ceil(max(ax, bx, cx))))
        miny = max(0, int(np.floor(min(ay, by, cy))))
        maxy = min(height - 1, int(np.ceil(max(ay, by, cy))))
        if minx > maxx or miny > maxy:
            continue
        px, py = np.meshgrid(
            np.arange(minx, maxx + 1, dtype=np.float32),
            np.arange(miny, maxy + 1, dtype=np.float32),
        )
        w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) / area
        w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) / area
        w2 = 1.0 - w0 - w1
        mask = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not mask.any():
            continue
        z = 1.0 / (w0 * inv_z[f, 0] + w1 * inv_z[f, 1] + w2 * inv_z[f, 2])
        sub_d = depth[miny : maxy + 1, minx : maxx + 1]
        sub_i = face_id[miny : maxy + 1, minx : maxx + 1]
        better = mask & ((sub_d == 0) | (z < sub_d))
        sub_d[better] = z[better]
        sub_i[better] = ids[f]
    return depth, face_id


def ray_mesh_intersections(
    verts: np.ndarray,
    faces: np.ndarray,
    origin: np.ndarray,
    direction: np.ndarray,
    max_hits: int = 64,
    use_native: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All (t, face) intersections of one ray with a mesh (unsorted).

    Möller–Trumbore; used for convex-hull grasp placement (native
    counterpart of the trimesh/rtree ray casting at reference
    ``simulator/physics/grasping.py:73-75``).  The library keeps the first
    ``max_hits``; ``use_native=False`` takes the numpy version.
    """
    verts = _as_f32(verts).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    origin = _as_f32(origin).reshape(3)
    direction = _as_f32(direction).reshape(3)
    if use_native is False:
        return _ray_mesh_numpy(verts, faces, origin, direction)
    t_out = np.zeros(max_hits, np.float32)
    f_out = np.zeros(max_hits, np.int32)
    n = load_library().ray_mesh_hits(
        verts.ctypes.data_as(_F32P),
        len(verts),
        faces.ctypes.data_as(_I32P),
        len(faces),
        origin.ctypes.data_as(_F32P),
        direction.ctypes.data_as(_F32P),
        t_out.ctypes.data_as(_F32P),
        f_out.ctypes.data_as(_I32P),
        max_hits,
    )
    return t_out[:n], f_out[:n]


def _ray_mesh_numpy(verts, faces, origin, direction):
    """Vectorized numpy Möller–Trumbore: every hit, not capped."""
    a = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - a
    e2 = verts[faces[:, 2]] - a
    p = np.cross(direction[None], e2)
    det = np.einsum("fd,fd->f", e1, p)
    ok = np.abs(det) > 1e-9
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = origin[None] - a
    u = np.einsum("fd,fd->f", s, p) * inv_det
    q = np.cross(s, e1)
    v = (q @ direction) * inv_det
    t = np.einsum("fd,fd->f", e2, q) * inv_det
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    idx = np.nonzero(hit)[0]
    return t[idx].astype(np.float32), idx.astype(np.int32)
