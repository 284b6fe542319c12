"""Corner detection: Sobel gradients, structure tensor, Shi-Tomasi & Harris.

Replacement for ``cv2.goodFeaturesToTrack``
(``processor.py:104, 322``): Sobel gradients -> windowed structure tensor ->
minimum-eigenvalue response -> 3x3 non-max suppression -> min-distance
enforcement -> top-k, all static-shaped with validity masks (SURVEY.md §2.4).

Deviation from OpenCV, by design: OpenCV enforces ``minDistance`` with a
greedy response-ordered scan (inherently sequential); here a best-per-cell
grid suppression gives the same spatial spreading as one data-parallel pass.
Corner *positions* therefore match OpenCV's strongest corners statistically,
not index-for-index — downstream KLT/pose parity is the contract (SURVEY.md
§7.3).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Corners", "sobel", "min_eig_response", "harris_response", "good_features"]


class Corners(NamedTuple):
    xy: jax.Array  # (K, 2) float32 (x, y) pixel coordinates
    response: jax.Array  # (K,) corner response
    mask: jax.Array  # (K,) bool validity


def _conv2(img: jax.Array, kernel: jax.Array) -> jax.Array:
    """Same-size 2D correlation with replicate borders (cv2 default)."""
    kh, kw = kernel.shape
    pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    img_p = jnp.pad(img, pad, mode="edge")
    return jax.lax.conv_general_dilated(
        img_p[None, None],
        kernel[None, None].astype(img.dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = _SOBEL_X.T


def sobel(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """3x3 Sobel derivatives (Ix, Iy), same shape as input."""
    return _conv2(img, _SOBEL_X), _conv2(img, _SOBEL_Y)


def _box(img: jax.Array, size: int) -> jax.Array:
    """Unnormalized box sum over a size x size window."""
    k = jnp.ones((size, size), img.dtype)
    return _conv2(img, k)


def structure_tensor(img: jax.Array, block_size: int = 7):
    ix, iy = sobel(img)
    return _box(ix * ix, block_size), _box(ix * iy, block_size), _box(iy * iy, block_size)


def min_eig_response(img: jax.Array, block_size: int = 7) -> jax.Array:
    """Shi-Tomasi: smaller eigenvalue of the windowed structure tensor
    (cv2.cornerMinEigenVal, the scorer inside goodFeaturesToTrack)."""
    a, b, c = structure_tensor(img, block_size)
    # Match cv2's normalization: gradients scaled by 1/(4*255*block) keeps
    # responses in a comparable range (only relative values matter for the
    # qualityLevel threshold, but comparable scales ease debugging).
    scale = 1.0 / (4.0 * 255.0 * block_size) ** 2
    half_tr = 0.5 * (a + c)
    rad = jnp.sqrt(jnp.maximum(((a - c) * 0.5) ** 2 + b * b, 0.0))
    return (half_tr - rad) * scale


def harris_response(img: jax.Array, block_size: int = 7, k: float = 0.04) -> jax.Array:
    """Harris cornerness det - k*trace^2 (cv2.cornerHarris; ORB's ranking)."""
    a, b, c = structure_tensor(img, block_size)
    scale = 1.0 / (4.0 * 255.0 * block_size) ** 2
    det = a * c - b * b
    tr = a + c
    return (det - k * tr * tr) * scale * scale


@partial(
    jax.jit,
    static_argnames=("max_corners", "block_size", "min_distance", "exact_topk"),
)
def good_features(
    img: jax.Array,
    max_corners: int = 512,
    quality_level: float = 0.01,
    min_distance: int = 7,
    block_size: int = 7,
    exact_topk: bool = False,
) -> Corners:
    """cv2.goodFeaturesToTrack equivalent with static output shape.

    Args:
      img: (H, W) grey image in [0, 255].
      max_corners: static output capacity K.
      quality_level: relative response threshold vs the strongest corner.
      min_distance: minimum spacing, enforced per grid cell.
      block_size: structure-tensor window.
      exact_topk: force the exact ``lax.top_k`` ranking (the original
        ordering) instead of the oversampled ``approx_max_k`` path — the same debugging escape hatch
        as ``board_detect.saddle_candidates`` / ``OrbConfig.topk_recall``.

    Returns:
      Corners with (K, 2) float32 (x, y), responses, and validity mask,
      sorted by response descending.
    """
    h, w = img.shape
    resp = min_eig_response(img, block_size)

    # 3x3 non-max suppression (cv2 dilate-and-compare).
    neighborhood = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    is_peak = resp >= neighborhood

    # Relative quality threshold.
    thresh = quality_level * jnp.max(resp)
    valid = is_peak & (resp > thresh)

    # Drop an image-border margin (cv2 excludes a few border pixels where the
    # window hangs off the image).
    margin = max(block_size // 2, 3)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid &= (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)

    # min-distance via best-per-cell: only the strongest corner in each
    # (min_distance x min_distance) cell survives.
    cell = min_distance if min_distance > 0 else 1
    n_cells_y = -(-h // cell)
    n_cells_x = -(-w // cell)
    cell_id = (yy // cell) * n_cells_x + (xx // cell)
    masked_resp = jnp.where(valid, resp, -jnp.inf)
    cell_max = jax.ops.segment_max(
        masked_resp.reshape(-1), cell_id.reshape(-1), num_segments=n_cells_y * n_cells_x
    )
    is_cell_best = masked_resp >= cell_max[cell_id]
    valid &= is_cell_best & jnp.isfinite(masked_resp)

    flat = jnp.where(valid, resp, -jnp.inf).reshape(-1)
    # 4x-oversampled approx_max_k + exact refine, safe against reduction-
    # bin collisions (a true top-k corner must also fall outside the
    # oversample to be lost). On the GPU approx_max_k lowers to an exact
    # sort, so this sorts twice (ROADMAP 3.3). Same pattern as
    # ops/board_detect.saddle_candidates.
    k_eff = min(max_corners, flat.shape[0])
    if exact_topk:
        top_resp, top_idx = jax.lax.top_k(flat, k_eff)
        top_idx = top_idx.astype(jnp.int32)
    else:
        k_over = min(4 * k_eff, flat.shape[0])
        over_resp, over_idx = jax.lax.approx_max_k(flat, k_over)
        top_resp, sel = jax.lax.top_k(over_resp, k_eff)
        top_idx = over_idx.astype(jnp.int32)[sel]
    if k_eff < max_corners:
        top_resp = jnp.pad(top_resp, (0, max_corners - k_eff), constant_values=-jnp.inf)
        top_idx = jnp.pad(top_idx, (0, max_corners - k_eff))
    ys = (top_idx // w).astype(jnp.float32)
    xs = (top_idx % w).astype(jnp.float32)
    mask = jnp.isfinite(top_resp)
    return Corners(
        xy=jnp.stack([xs, ys], axis=-1),
        response=jnp.where(mask, top_resp, 0.0),
        mask=mask,
    )
