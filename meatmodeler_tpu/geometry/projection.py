"""Pinhole camera projection — the residual kernel of bundle adjustment.

JAX equivalent of the reference's NumPy residual core
(``bundleAdjuster.py:7-52``: ``rotate`` + ``project``): rotate 3D points by
per-observation axis-angle vectors, translate, apply the intrinsic matrix and
perspective-divide. Pure JAX, broadcastable over leading batch dims, and
differentiable — the bundle adjuster gets its analytic Jacobians from
``jax.jacfwd`` of these functions rather than finite differences.

Also provides extrinsic-matrix <-> parameter-vector packing, replacing
``frameParameters`` / ``reformatPointResult`` / ``reformatPoseResult``
(``bundleAdjuster.py:105-157, 197-203``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

from meatmodeler_tpu.geometry import so3

__all__ = [
    "rotate_points",
    "project_points",
    "params_from_extrinsics",
    "extrinsics_from_params",
    "projection_from_extrinsic",
]


@matmul_highp
def rotate_points(points: jax.Array, rvecs: jax.Array) -> jax.Array:
    """Rodrigues-rotate each point by its paired axis-angle vector.

    Semantics of ``bundleAdjuster.rotate`` (``bundleAdjuster.py:7-28``) with a
    smooth small-angle guard instead of ``nan_to_num``.

    Args:
      points: (..., 3) 3D points.
      rvecs: (..., 3) axis-angle rotation vectors, broadcastable with points.

    Returns:
      (..., 3) rotated points.
    """
    points, rvecs = jnp.broadcast_arrays(jnp.asarray(points), jnp.asarray(rvecs))
    theta_sq = jnp.sum(rvecs * rvecs, axis=-1, keepdims=True)
    small = theta_sq < 1e-12

    # DIFFERENTIABILITY at the identity is load-bearing, not cosmetic: the
    # anchor camera of every reconstruction has rvec exactly 0, and this
    # function sits inside the BA Jacobian. Two NaN traps live here:
    #   1. sqrt(0) has an infinite derivative, so the guard must be INSIDE
    #      the sqrt (sqrt(where(small, 1, x)), never where(small, 1, sqrt(x))
    #      — the zero cotangent into the untaken branch still meets d sqrt's
    #      inf and 0 * inf = NaN);
    #   2. every use of theta (including cos(theta)) needs a small-branch
    #      Taylor polynomial in theta_sq.
    # Unguarded, the whole LM camera gradient went NaN whenever any camera
    # sat at the identity, silently railing the damping without ever
    # accepting a step (caught by tests/test_gpu_device.py::
    # test_global_ba_converges_on_device).
    safe_theta_sq = jnp.where(small, 1.0, theta_sq)
    safe_theta = jnp.sqrt(safe_theta_sq)

    # Rodrigues: p' = cos(th) p + sin(th) (v x p) + (1 - cos th) (v . p) v
    # with v the unit axis. Rewritten against the *unnormalized* rvec k:
    # p' = cos(th) p + (sin th / th) (k x p) + ((1 - cos th)/th^2) (k . p) k,
    # both coefficients smooth through th = 0.
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe_theta) / safe_theta)
    b = jnp.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(safe_theta)) / safe_theta_sq
    )
    cos_theta = jnp.where(
        small, 1.0 - theta_sq / 2.0 + theta_sq * theta_sq / 24.0,
        jnp.cos(safe_theta),
    )

    cross = jnp.cross(rvecs, points)
    dot = jnp.sum(points * rvecs, axis=-1, keepdims=True)
    return cos_theta * points + a * cross + b * dot * rvecs


@matmul_highp
def project_points(points: jax.Array, cam_params: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """Project 3D points through per-observation camera parameters.

    Semantics of ``bundleAdjuster.project`` (``bundleAdjuster.py:31-52``):
    rotate, translate, multiply by K, perspective-divide.

    Args:
      points: (..., 3) 3D world points.
      cam_params: (..., 6) per-observation camera parameters
        ``[rvec (3), tvec (3)]``, broadcastable with points.
      intrinsics: (3, 3) camera intrinsic matrix K.

    Returns:
      (..., 2) projected pixel coordinates.
    """
    cam = rotate_points(points, cam_params[..., :3]) + cam_params[..., 3:6]
    homog = jnp.einsum("ij,...j->...i", intrinsics, cam)
    return homog[..., :2] / homog[..., 2:3]


@matmul_highp
def params_from_extrinsics(extrinsics: jax.Array) -> jax.Array:
    """Pack (..., 3, 4) or (..., 4, 4) extrinsic matrices [R|t] into (..., 6).

    The log-map packing of ``frameParameters`` (``bundleAdjuster.py:105-134``)
    — which likewise accepts either 3x4 or 4x4 input — returned flat per-frame;
    here batched and unflattened (callers reshape if they need (6F,)).
    """
    rot = extrinsics[..., :3, :3]
    tvec = extrinsics[..., :3, 3]
    return jnp.concatenate([so3.log(rot), tvec], axis=-1)


@matmul_highp
def extrinsics_from_params(params: jax.Array, homogeneous: bool = False) -> jax.Array:
    """Unpack (..., 6) camera parameters to extrinsic matrices.

    ``homogeneous=False`` -> (..., 3, 4) like ``reformatPoseResult``
    (``bundleAdjuster.py:197-203``); ``True`` -> (..., 4, 4) like
    ``reformatPointResult`` (``bundleAdjuster.py:137-157``).
    """
    rot = so3.exp(params[..., :3])
    ext = jnp.concatenate([rot, params[..., 3:6, None]], axis=-1)
    if homogeneous:
        bottom = jnp.zeros_like(ext[..., :1, :]).at[..., 0, 3].set(1.0)
        ext = jnp.concatenate([ext, bottom], axis=-2)
    return ext


@matmul_highp
def projection_from_extrinsic(intrinsics: jax.Array, extrinsic: jax.Array) -> jax.Array:
    """P = K @ [R|t] for (..., 3, 4) extrinsics (``processor.py:184,448``)."""
    return jnp.einsum("ij,...jk->...ik", intrinsics, extrinsic[..., :3, :])
