"""Normalized DLT homography estimation (building block for Zhang calibration).

The reference delegates calibration entirely to ``cv2.calibrateCamera``
(``processor.py:49-53``); the rebuild initializes intrinsics from planar
homographies (Zhang's method) and refines with Gauss-Newton
(``calibration.py``). Batched over views with ``vmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

__all__ = ["find_homography", "normalize_points"]


@matmul_highp
def normalize_points(pts: jax.Array):
    """Hartley normalization: translate to centroid, scale to mean dist sqrt(2).

    Args:
      pts: (N, 2).

    Returns:
      (pts_normalized (N, 2), T (3, 3)) with pts_n ~ T @ [pts; 1].
    """
    centroid = jnp.mean(pts, axis=0)
    centered = pts - centroid
    mean_dist = jnp.mean(jnp.linalg.norm(centered, axis=1))
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-12)
    t = jnp.array(
        [
            [1.0, 0.0, -centroid[0]],
            [0.0, 1.0, -centroid[1]],
            [0.0, 0.0, 1.0],
        ]
    ) * jnp.array([[scale], [scale], [1.0]])
    return centered * scale, t


@matmul_highp
def find_homography(src: jax.Array, dst: jax.Array) -> jax.Array:
    """DLT homography with Hartley normalization: dst ~ H @ src.

    Args:
      src: (N, 2) source points (N >= 4).
      dst: (N, 2) destination points.

    Returns:
      (3, 3) homography, normalized so H[2, 2] = 1.
    """
    src_n, t_src = normalize_points(src)
    dst_n, t_dst = normalize_points(dst)

    x, y = src_n[:, 0], src_n[:, 1]
    u, v = dst_n[:, 0], dst_n[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)

    rows_u = jnp.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], axis=-1)
    rows_v = jnp.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], axis=-1)
    design = jnp.concatenate([rows_u, rows_v], axis=0)  # (2N, 9)

    ata = design.T @ design
    _, vecs = jnp.linalg.eigh(ata)
    h_n = vecs[:, 0].reshape(3, 3)

    h = jnp.linalg.solve(t_dst, h_n @ t_src)
    return h / h[2, 2]
