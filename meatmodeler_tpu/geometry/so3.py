"""SO(3) exponential / logarithm maps (axis-angle <-> rotation matrix).

Replacement for every ``cv2.Rodrigues`` call site in the reference
(``processor.py:182``, ``bundleAdjuster.py:153,201``) and for the hand-rolled
NumPy log map ``frameParameters`` (``bundleAdjuster.py:105-134``).

Everything here is pure JAX, shape-polymorphic over leading batch dimensions,
differentiable, and numerically guarded at the th->0 and th->pi singularities
(the reference handles th->0 with ``np.nan_to_num`` which silently zeroes the
rotation; we instead use Taylor expansions so gradients stay correct).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

__all__ = ["hat", "exp", "log", "exp_log_consistent"]

# Below this angle the closed forms are replaced with Taylor expansions.
_SMALL_ANGLE = 1e-6


@matmul_highp
def hat(v: jax.Array) -> jax.Array:
    """Skew-symmetric (cross-product) matrix of ``v``: hat(v) @ x == cross(v, x).

    Args:
      v: (..., 3) vectors.

    Returns:
      (..., 3, 3) skew-symmetric matrices.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    return rows


@matmul_highp
def exp(rvec: jax.Array) -> jax.Array:
    """Axis-angle -> rotation matrix (the Rodrigues formula).

    R = I + a*K + b*K^2 with K = hat(rvec), a = sin(th)/th, b = (1-cos th)/th^2.
    Small angles use the Taylor expansions a ~ 1 - th^2/6, b ~ 1/2 - th^2/24 so
    the map is smooth (and differentiable) through th = 0.

    Args:
      rvec: (..., 3) axis-angle vectors (axis * angle-in-radians).

    Returns:
      (..., 3, 3) rotation matrices.
    """
    rvec = jnp.asarray(rvec)
    theta_sq = jnp.sum(rvec * rvec, axis=-1)
    small = theta_sq < _SMALL_ANGLE**2

    # Guard INSIDE the sqrt (see rotate_points: sqrt(0) has an infinite
    # derivative, and where-after-sqrt still leaks NaN into any gradient
    # taken through an identity rotation).
    safe_theta_sq = jnp.where(small, 1.0, theta_sq)
    safe_theta = jnp.sqrt(safe_theta_sq)

    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe_theta) / safe_theta)
    b = jnp.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(safe_theta)) / safe_theta_sq
    )

    k = hat(rvec)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


@matmul_highp
def log(rot: jax.Array) -> jax.Array:
    """Rotation matrix -> axis-angle (inverse Rodrigues).

    Same quantity as the reference's ``frameParameters`` log map
    (``bundleAdjuster.py:117-131``) but additionally correct near th = pi,
    where the skew-part formula degenerates (the reference's ``nan_to_num``
    would silently zero it).

    Args:
      rot: (..., 3, 3) rotation matrices.

    Returns:
      (..., 3) axis-angle vectors with angle in [0, pi].
    """
    rot = jnp.asarray(rot)
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)

    # Vector from the skew-symmetric part: (R - R^T)^vee / 2 = sin(th) * axis.
    skew = jnp.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        axis=-1,
    ) * 0.5
    # atan2 angle: arccos of the trace loses precision catastrophically as
    # th -> pi (d arccos blows up), while atan2(|sin|, cos) stays exact.
    # `small` is decided from sin^2 (smooth) BEFORE any sqrt so the norm can
    # be guarded inside it — |skew| at the identity otherwise injects NaN
    # into every gradient through log (same trap as rotate_points).
    sin_sq = jnp.sum(skew * skew, axis=-1)
    small = (sin_sq < _SMALL_ANGLE**2) & (cos_theta > 0.0)
    # The pi-side analog of `small`: at theta exactly pi (e.g. an axis-
    # aligned half turn, R = diag(1,-1,-1)) sin_sq is exactly 0 with
    # cos_theta < 0, and an unguarded sqrt(0) would NaN gradients through
    # theta just like the identity case — pin sin to 0 there (theta comes
    # out exactly pi; |theta error| <= 1e-6 over the pinned band).
    sin_zero = sin_sq < _SMALL_ANGLE**2
    sin_norm = jnp.sqrt(jnp.where(sin_zero, 1.0, sin_sq))
    theta = jnp.arctan2(jnp.where(sin_zero, 0.0, sin_norm), cos_theta)
    # The diagonal-based axis extraction below is exact for ALL theta (the
    # diag of R is cos + (1-cos) a_i^2 with no sin term), so switch to it
    # well before sin(th) gets small: the generic skew formula amplifies
    # float32 matrix noise by th/sin(th) (~250x at th = pi - 0.013 — tens of
    # pixels of pose error downstream).
    near_pi = theta > 2.0

    # Generic branch: rvec = th / sin(th) * skew_vee.
    sin_theta = jnp.sin(jnp.where(small | near_pi, 1.0, theta))
    generic = skew * (theta / sin_theta)[..., None]

    # Small branch: rvec ~ skew_vee * (1 + th^2/6), with th^2 ~ sin^2 th
    # (identical to O(th^4), and a smooth polynomial of the matrix entries —
    # `theta` itself is pinned to 0 for small entries above).
    small_branch = skew * (1.0 + sin_sq / 6.0)[..., None]

    # Near-pi branch: axis from the diagonal of R = I + (1-cos)*aa^T + ...
    # outer = (R + I)/2 -> diag gives axis^2 * (1-cos)/2 + ...; standard recipe:
    # axis_i = sqrt(max(0, (R_ii + 1) / 2 / (1 - cos_th) ... )) -- use the
    # robust formulation via the largest diagonal element.
    diag = jnp.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], axis=-1)
    # B = (R - cos*I) / (1 - cos) = aa^T  (exact at th = pi).
    one_minus_cos = jnp.where(near_pi, 1.0 - cos_theta, 1.0)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0, 1.0)
    # Guard inside the sqrt again — PER COMPONENT, not per row: away from
    # the near-pi branch axis_sq clips to exactly 0 (the identity), and
    # INSIDE the taken branch an axis-aligned pi rotation (R = diag(1,-1,-1))
    # still has two components exactly 0 — either way sqrt(0)'s infinite
    # derivative would NaN every gradient through log. Components at (or
    # clipped to) 0 are pinned to 0 OUTSIDE the sqrt, mirroring the
    # rotate_points pattern.
    axis_ok = near_pi[..., None] & (axis_sq > _SMALL_ANGLE**2)
    axis_abs = jnp.where(
        axis_ok, jnp.sqrt(jnp.where(axis_ok, axis_sq, 1.0)), 0.0
    )
    # Fix signs from the off-diagonal symmetric part: (R+R^T)/2 off-diags are
    # axis_i*axis_j*(1-cos). Pick the sign relative to the largest component.
    # Sign recovery: with the largest component taken positive, the minor
    # components' signs follow from the symmetric products
    # (R + R^T)_ij / 2 = axis_i * axis_j * (1 - cos th)  (i != j).
    sym01 = rot[..., 0, 1] + rot[..., 1, 0]
    sym02 = rot[..., 0, 2] + rot[..., 2, 0]
    sym12 = rot[..., 1, 2] + rot[..., 2, 1]
    major = jnp.argmax(axis_abs, axis=-1)

    sgn = lambda s: jnp.where(s < 0, -1.0, 1.0)
    a0, a1, a2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    # major == 0: (+a0, a1*sgn(s01), a2*sgn(s02))
    # major == 1: (a0*sgn(s01), +a1, a2*sgn(s12))
    # major == 2: (a0*sgn(s02), a1*sgn(s12), +a2)
    x0 = jnp.where(major == 0, a0, jnp.where(major == 1, a0 * sgn(sym01), a0 * sgn(sym02)))
    x1 = jnp.where(major == 0, a1 * sgn(sym01), jnp.where(major == 1, a1, a1 * sgn(sym12)))
    x2 = jnp.where(major == 0, a2 * sgn(sym02), jnp.where(major == 1, a2 * sgn(sym12), a2))
    pi_axis = jnp.stack([x0, x1, x2], axis=-1)
    # Align with the skew part (skew_vee = sin(th) * axis, sin(th) >= 0 on
    # [0, pi]) for continuity with the generic branch; at exactly pi either
    # sign is a valid log.
    align = jnp.sum(pi_axis * skew, axis=-1)
    pi_axis = pi_axis * jnp.where(align < 0, -1.0, 1.0)[..., None]
    pi_branch = pi_axis * theta[..., None]

    out = jnp.where(small[..., None], small_branch, generic)
    out = jnp.where(near_pi[..., None], pi_branch, out)
    return out


@matmul_highp
def exp_log_consistent(rvec: jax.Array) -> jax.Array:
    """Round-trip helper used in tests: log(exp(rvec))."""
    return log(exp(rvec))
