"""OpenCV-compatible lens distortion model (k1, k2, p1, p2, k3).

The reference never models distortion itself — it passes the coefficients
from ``cv2.calibrateCamera`` straight back into ``cv2.solvePnP``
(``processor.py:175-179, 422``). The rebuild needs the model explicitly:
``distort`` is applied inside calibration's reprojection residual, and
``undistort_points`` (fixed-point iteration, batched) normalizes observed
pixels once so downstream PnP/triangulation/BA can use the ideal pinhole
model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["distort_normalized", "distort_pixels", "undistort_pixels"]


def distort_normalized(xy: jax.Array, dist: jax.Array) -> jax.Array:
    """Apply distortion to normalized image coordinates.

    Args:
      xy: (..., 2) normalized coordinates (x/z, y/z).
      dist: (5,) coefficients [k1, k2, p1, p2, k3] (OpenCV order).

    Returns:
      (..., 2) distorted normalized coordinates.
    """
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def distort_pixels(pix: jax.Array, intrinsics: jax.Array, dist: jax.Array) -> jax.Array:
    """Ideal pixel coords -> distorted pixel coords."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xy = (pix - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    xyd = distort_normalized(xy, dist)
    return xyd * jnp.stack([fx, fy]) + jnp.stack([cx, cy])


def undistort_pixels(
    pix: jax.Array, intrinsics: jax.Array, dist: jax.Array, iters: int = 8
) -> jax.Array:
    """Distorted pixel coords -> ideal pixel coords (cv2.undistortPoints).

    Fixed-point iteration x_{n+1} = (x_d - tangential(x_n)) / radial(x_n),
    the same scheme OpenCV uses; ``iters=8`` matches its default ``criteria``
    regime for moderate distortion.
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xyd = (pix - jnp.stack([cx, cy])) / jnp.stack([fx, fy])

    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]

    def body(_, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xyd[..., 0] - dx) / radial
        yn = (xyd[..., 1] - dy) / radial
        return jnp.stack([xn, yn], axis=-1)

    xy = jax.lax.fori_loop(0, iters, body, xyd)
    return xy * jnp.stack([fx, fy]) + jnp.stack([cx, cy])
