"""Color-space conversions (BGR <-> grey / LAB), batched JAX.

JAX equivalent of the ``cv2.cvtColor`` / ``split`` / ``merge`` call
sites (``processor.py:19-26, 314, 357``). These are pure elementwise maps —
XLA fuses them with neighbouring ops (e.g. CLAHE's LUT application), so no
Pallas kernel is warranted (SURVEY.md §2.4: "trivial vmapped JAX" tier).

Formulas follow OpenCV's 8-bit conventions (BT.601 grey weights; CIE LAB on
un-linearized RGB with L scaled to [0,255], a/b offset by 128) so values are
held to per-pixel tolerance against ``cv2.cvtColor``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bgr_to_grey", "bgr_to_lab", "lab_to_bgr"]

# sRGB (D65) <-> XYZ matrices, as used by OpenCV's Lab conversion.
# Host constants: a device array here would start the backend at import.
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ2RGB = np.array(
    [
        [3.240479, -1.53715, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
# D65 white point normalization applied to X and Z.
_WHITE = np.array([0.950456, 1.0, 1.088754])


def _matvec3(m: jax.Array, v: jax.Array) -> jax.Array:
    """Unrolled 3x3 @ (..., 3): elementwise multiply-adds that XLA fuses
    with their neighbours, instead of a matmul with a 3-wide contraction
    over a large image array."""
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m[0, 0] * c0 + m[0, 1] * c1 + m[0, 2] * c2,
            m[1, 0] * c0 + m[1, 1] * c1 + m[1, 2] * c2,
            m[2, 0] * c0 + m[2, 1] * c1 + m[2, 2] * c2,
        ],
        axis=-1,
    )


def bgr_to_grey(bgr: jax.Array) -> jax.Array:
    """BT.601 luma: Y = 0.299 R + 0.587 G + 0.114 B (cv2.COLOR_BGR2GRAY).

    Args:
      bgr: (..., H, W, 3) image, uint8 or float in [0, 255], channels B,G,R.

    Returns:
      (..., H, W) float32 grey in [0, 255].
    """
    x = bgr.astype(jnp.float32)
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


def _f_cbrt(t: jax.Array) -> jax.Array:
    """CIE f(t): cube root above the 0.008856 knee, linear segment below."""
    return jnp.where(t > 0.008856, jnp.cbrt(t), 7.787 * t + 16.0 / 116.0)


def _srgb_to_linear(v: jax.Array) -> jax.Array:
    return jnp.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)


def _linear_to_srgb(v: jax.Array) -> jax.Array:
    v = jnp.maximum(v, 0.0)
    return jnp.where(v > 0.0031308, 1.055 * v ** (1.0 / 2.4) - 0.055, 12.92 * v)


def bgr_to_lab(bgr: jax.Array) -> jax.Array:
    """cv2.COLOR_BGR2LAB for 8-bit images (with sRGB linearization, as OpenCV
    applies via its gamma LUT).

    Args:
      bgr: (..., H, W, 3) uint8/float [0, 255] B,G,R.

    Returns:
      (..., H, W, 3) float32 [L, a, b] in OpenCV's 8-bit scaling:
      L in [0, 255] (L* * 255/100), a/b offset by 128.
    """
    rgb = _srgb_to_linear(bgr.astype(jnp.float32)[..., ::-1] / 255.0)
    xyz = _matvec3(_RGB2XYZ, rgb) / _WHITE
    fx, fy, fz = _f_cbrt(xyz[..., 0]), _f_cbrt(xyz[..., 1]), _f_cbrt(xyz[..., 2])
    l_star = 116.0 * fy - 16.0
    a_star = 500.0 * (fx - fy)
    b_star = 200.0 * (fy - fz)
    return jnp.stack(
        [l_star * (255.0 / 100.0), a_star + 128.0, b_star + 128.0], axis=-1
    )


def lab_to_bgr(lab: jax.Array) -> jax.Array:
    """Inverse of :func:`bgr_to_lab` (cv2.COLOR_Lab2BGR, 8-bit scaling).

    Returns (..., H, W, 3) float32 B,G,R clipped to [0, 255].
    """
    l_star = lab[..., 0] * (100.0 / 255.0)
    a_star = lab[..., 1] - 128.0
    b_star = lab[..., 2] - 128.0

    fy = (l_star + 16.0) / 116.0
    fx = fy + a_star / 500.0
    fz = fy - b_star / 200.0

    def f_inv(f):
        t = f * f * f
        return jnp.where(t > 0.008856, t, (f - 16.0 / 116.0) / 7.787)

    xyz = jnp.stack([f_inv(fx), f_inv(fy), f_inv(fz)], axis=-1) * _WHITE
    rgb = _linear_to_srgb(_matvec3(_XYZ2RGB, xyz))
    bgr = jnp.clip(rgb[..., ::-1] * 255.0, 0.0, 255.0)
    return bgr
