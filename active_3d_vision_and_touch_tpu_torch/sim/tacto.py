"""DIGIT/TACTO-style colored gel renderer.

The port's copy of the JAX package's ``sim/tacto.py``, with one difference:
the calibration blur is always OpenCV's ``GaussianBlur(img, (7, 7), 0)``,
the blur of the reference TACTO renderer, computed in numpy.  The JAX
package calls OpenCV when ``cv2`` imports and a sampled Gaussian otherwise,
two blurs that differ by up to 0.75 of 255 at the border.

Alternative touch-signal model to :mod:`sim.touch_render`, reproducing the
reference TACTO pipeline (``simulator/rendering/tacto_renderer.py:18-309``)
stage by stage, but computed directly in the sensor's depth-image plane
instead of a second pyrender scene (pyrender does not exist here, and the
depth map already carries the contact geometry):

1. **Gel geometry** — the resting elastomer is the spherical cap the
   reference builds as a trimesh (``_generate_gel_trimesh``: sphere radius
   R=0.1 m over a 0.02x0.03 m window, peak deflection ``zrange``=5 mm).
   Contact presses the object's depth profile into that cap (pointwise
   min of gel height and object surface).
2. **Illumination** — three point LEDs at polar angles 30/150/270 deg on a
   0.02 m rim circle (``_init_light``), pure R/G/B, with Lambertian
   shading and inverse-square falloff (pyrender point lights).
3. **Calibration** — background subtraction exactly as ``_calibrate``:
   ``diff = (render - background_sim) * 0.5`` then a 7x7 Gaussian blur,
   composited over a (real or synthetic) background frame.
4. **Noise** — Gaussian sigma=7 as in ``_add_noise``.

Selected with ``SimConfig(tacto=True)`` (which also clamps the sensing
range to 15 mm, reference ``instance.py:46-48``).
"""

from __future__ import annotations

import numpy as np

# reference _init_light: polar angles (deg) on a 0.02 m rim, pure RGB
_LED_THETAS_DEG = (30.0, 150.0, 270.0)
_LED_RADIUS = 0.02
_LED_COLORS = np.eye(3)
_LED_HEIGHT = 0.005  # LEDs sit at the gel's base plane above the window
# reference _generate_gel_trimesh constants
_GEL_W, _GEL_H = 0.02, 0.03
_SPHERE_R = 0.1
_ZRANGE = 0.005
_NOISE_STD = 7.0  # reference _add_noise
_CALIB_SCALE = 0.5  # reference _calibrate
# OpenCV's fixed 7-tap Gaussian, the one GaussianBlur takes for ksize 7 and
# sigma <= 0 (its small_gaussian_tab)
_BLUR_TAPS = np.array([1.0, 3.5, 7.0, 9.0, 7.0, 3.5, 1.0], np.float32) / 32.0


def _gaussian_blur(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (7, 7), 0)`` on an (H, W[, C]) float image:
    the separable fixed table over rows and columns in float32, the border
    mirrored without repeating its edge pixel (OpenCV's BORDER_REFLECT_101,
    numpy's ``reflect``)."""
    out = np.asarray(img, np.float32)
    r = len(_BLUR_TAPS) // 2
    for axis in (0, 1):
        n = out.shape[axis]
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        padded = np.pad(out, pad, mode="reflect")
        acc = np.zeros_like(out)
        for k, w in enumerate(_BLUR_TAPS):
            acc += w * np.take(padded, np.arange(k, k + n), axis=axis)
        out = acc
    return out


class TactoRenderer:
    def __init__(
        self,
        resolution: int = 121,
        max_depth: float = 0.015,
        seed: int = 0,
        background_real: np.ndarray | None = None,
    ):
        self.resolution = resolution
        self.max_depth = max_depth
        self.rng = np.random.default_rng(seed)

        # metric grid over the gel window (use the short side so the square
        # sensor window fits inside the reference's 0.02 x 0.03 patch)
        lin = np.linspace(-_GEL_W / 2, _GEL_W / 2, resolution)
        self._xx, self._yy = np.meshgrid(lin, lin)

        # spherical-cap resting gel: h = R - sqrt(R^2 - x^2 - y^2), scaled
        # to a peak deflection of _ZRANGE (reference xx = X0 - zrange*h/h.max())
        h = _SPHERE_R - np.sqrt(
            np.maximum(_SPHERE_R**2 - self._xx**2 - self._yy**2, 0.0)
        )
        self._rest_gel = _ZRANGE * (1.0 - h / h.max())  # peak at center

        # one synthetic background frame: the UNDEFORMED gel under the LEDs
        # (reference renders the empty scene once at init: _background_sim)
        self._background_sim = self._shade(self._rest_gel)
        # "real" background to composite the calibrated diff over; the
        # reference loads a photo of the actual sensor — default to the
        # simulated one so the pipeline is a no-op on empty frames
        self._background_real = (
            np.asarray(background_real, np.float32)
            if background_real is not None
            else self._background_sim.copy()
        )

    # ------------------------------------------------------------- shading
    def _shade(self, height: np.ndarray) -> np.ndarray:
        """Gel height field → RGB via 3 rim point-LEDs (Lambert + 1/d^2)."""
        zy, zx = np.gradient(height, self._yy[:, 0], self._xx[0])
        normal = np.dstack([-zx, -zy, np.ones_like(height)])
        normal /= np.linalg.norm(normal, axis=2, keepdims=True)
        surface = np.dstack([self._xx, self._yy, height])

        img = np.zeros((self.resolution, self.resolution, 3), np.float32)
        for theta, color in zip(np.deg2rad(_LED_THETAS_DEG), _LED_COLORS):
            led = np.array(
                [np.cos(theta) * _LED_RADIUS, np.sin(theta) * _LED_RADIUS, _LED_HEIGHT]
            )
            l_vec = led - surface
            dist2 = np.sum(l_vec**2, axis=2, keepdims=True)
            l_dir = l_vec / np.sqrt(dist2)
            diffuse = np.clip((normal * l_dir).sum(-1), 0.0, 1.0)
            # inverse-square falloff, normalized to the rim distance so the
            # image sits in display range at intensity 1 like pyrender's
            falloff = (_LED_RADIUS**2) / dist2[..., 0]
            img += (diffuse * falloff)[..., None] * color * 255.0
        return np.clip(img, 0, 255)

    # ------------------------------------------------------------- render
    def render(self, depth: np.ndarray, noise: bool = True, calibration: bool = True):
        """(H, W) sensor depth (0 = no hit) → (H, W, 3) gel image uint8 range."""
        depth = np.asarray(depth, np.float64).copy()
        depth[(depth == 0) | (depth > self.max_depth)] = self.max_depth
        # object surface height above the sensor base plane; pressing into
        # the gel means the gel surface is the MIN of rest gel and object
        indentation = (self.max_depth - depth) / self.max_depth  # 0..1
        obj_height = self._rest_gel + indentation * _ZRANGE
        gel = np.maximum(self._rest_gel, obj_height)  # deformed gel surface

        color = self._shade(gel)
        if calibration:
            diff = (color - self._background_sim) * _CALIB_SCALE
            diff = _gaussian_blur(diff)
            color = np.clip(diff + self._background_real, 0, 255)
        if noise:
            color = np.clip(
                color + self.rng.normal(0.0, _NOISE_STD, color.shape), 0, 255
            )
        return color
