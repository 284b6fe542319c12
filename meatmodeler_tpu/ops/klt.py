"""Pyramidal Lucas-Kanade optical flow, vmapped over points.

Replacement for ``cv2.calcOpticalFlowPyrLK``
(``processor.py:79-83`` — the per-frame hot path of keyframe selection).
Design per SURVEY.md §2.4: image pyramid + iterative LK solve, ``vmap`` over
points, static iteration counts with convergence masking (the
data-dependent-stop equivalent of cv2's termination criteria).

Returns cv2-compatible outputs: tracked points, a status flag, and the mean
absolute intensity error of the final window (what the reference accumulates
into its keyframe score, ``processor.py:95-97``).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["FlowResult", "build_pyramid", "lucas_kanade"]


class FlowResult(NamedTuple):
    points: jax.Array  # (N, 2) tracked (x, y)
    status: jax.Array  # (N,) bool — tracked successfully
    error: jax.Array  # (N,) mean |I_prev - I_curr| over the window


_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _blur5(img: jax.Array) -> jax.Array:
    """Separable 5-tap Gaussian (cv2's pyrDown kernel), dtype-preserving."""
    g = _GAUSS5.astype(img.dtype)
    pad_y = jnp.pad(img, ((2, 2), (0, 0)), mode="edge")
    tmp = sum(g[i] * pad_y[i : i + img.shape[0]] for i in range(5))
    pad_x = jnp.pad(tmp, ((0, 0), (2, 2)), mode="edge")
    return sum(g[i] * pad_x[:, i : i + img.shape[1]] for i in range(5))


def build_pyramid(img: jax.Array, levels: int) -> List[jax.Array]:
    """Gaussian pyramid, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        blurred = _blur5(pyr[-1])
        pyr.append(blurred[::2, ::2])
    return pyr


def _bilinear_window(img: jax.Array, center: jax.Array, win: int) -> jax.Array:
    """Sample a (win x win) patch around float `center` (x, y), bilinear.

    One ``dynamic_slice`` of (win+1, win+1) plus four static shifted views —
    under ``vmap`` this lowers to a contiguous block gather instead of a
    per-element advanced-indexing gather (529 scattered loads per window).
    Whether the scattered gather is as fast on the GPU is unmeasured
    (ROADMAP).
    """
    half = (win - 1) / 2.0
    # Edge-pad so border windows sample replicate-padded pixels instead of a
    # silently shifted window (which sends the LK iteration divergent at
    # coarse pyramid levels where win ~ image size). The pad is
    # batch-invariant, so XLA hoists it out of the per-point vmap.
    pad = win + 1
    img = jnp.pad(img, pad, mode="edge")
    h, w = img.shape
    tl = center - half + pad  # float top-left corner (x, y) in padded coords
    t0 = jnp.floor(tl)
    fx = tl[0] - t0[0]
    fy = tl[1] - t0[1]
    x0 = jnp.clip(t0[0].astype(jnp.int32), 0, w - win - 1)
    y0 = jnp.clip(t0[1].astype(jnp.int32), 0, h - win - 1)
    big = jax.lax.dynamic_slice(img, (y0, x0), (win + 1, win + 1))
    return (
        big[:-1, :-1] * (1 - fy) * (1 - fx)
        + big[:-1, 1:] * (1 - fy) * fx
        + big[1:, :-1] * fy * (1 - fx)
        + big[1:, 1:] * fy * fx
    )


def _lk_level(
    prev_img: jax.Array,
    curr_img: jax.Array,
    prev_pt: jax.Array,
    guess: jax.Array,
    win: int,
    max_iters: int,
    eps: float,
):
    """Iterative LK at one pyramid level for one point.

    Returns (refined displacement, min eigenvalue of G / window area).
    """
    # Template patch and its gradients, fixed per level (cv2 uses Scharr-like
    # central differences of the *previous* image patch).
    patch_p = _bilinear_window(prev_img, prev_pt, win + 2)
    ix = (patch_p[1:-1, 2:] - patch_p[1:-1, :-2]) * 0.5
    iy = (patch_p[2:, 1:-1] - patch_p[:-2, 1:-1]) * 0.5
    tmpl = patch_p[1:-1, 1:-1]

    gxx = jnp.sum(ix * ix)
    gxy = jnp.sum(ix * iy)
    gyy = jnp.sum(iy * iy)
    det = gxx * gyy - gxy * gxy
    # Spectral condition: smaller eigenvalue, normalized by window area
    # (cv2's minEigThreshold semantics).
    half_tr = 0.5 * (gxx + gyy)
    min_eig = (half_tr - jnp.sqrt(jnp.maximum(half_tr**2 - det, 0.0))) / (win * win)
    ok = det > 1e-7

    inv = (
        jnp.array([[gyy, -gxy], [-gxy, gxx]])
        / jnp.where(ok, det, 1.0)
    )

    def body(_, d):
        curr = _bilinear_window(curr_img, prev_pt + d, win)
        diff = tmpl - curr
        b = jnp.array([jnp.sum(diff * ix), jnp.sum(diff * iy)])
        delta = inv @ b
        # Freeze once the update is below eps (cv2 TERM_CRITERIA_EPS).
        small = jnp.sum(delta * delta) < eps * eps
        return jnp.where(small | ~ok, d, d + delta)

    d = jax.lax.fori_loop(0, max_iters, body, guess)
    return d, min_eig, ok


@partial(jax.jit, static_argnames=("win", "levels", "max_iters"))
def lucas_kanade(
    prev_pyr: Tuple[jax.Array, ...],
    curr_pyr: Tuple[jax.Array, ...],
    points: jax.Array,
    win: int = 21,
    levels: int = 4,
    max_iters: int = 30,
    eps: float = 0.01,
    point_mask: jax.Array | None = None,
    initial_flow: jax.Array | None = None,
) -> FlowResult:
    """Track `points` from the previous to the current frame.

    Args:
      prev_pyr / curr_pyr: pyramids from :func:`build_pyramid` (tuples so the
        jit cache keys on shapes).
      points: (N, 2) float (x, y) positions in the previous frame.
      win: odd window size (cv2 default 21).
      levels: pyramid levels to use (<= len(pyr)).
      max_iters / eps: termination criteria (cv2 defaults 30, 0.01).
      point_mask: (N,) bool — padding entries skip work via masking.
      initial_flow: optional (N, 2) full-resolution displacement guess (the
        OPTFLOW_USE_INITIAL_FLOW mode) — e.g. descriptor-match offsets that
        LK then polishes to sub-pixel.

    Returns:
      FlowResult(points (N, 2), status (N,), error (N,)).
    """
    n = points.shape[0]
    # One common dtype end-to-end (images may arrive f64 under x64 tests).
    points = points.astype(prev_pyr[0].dtype)
    if point_mask is None:
        point_mask = jnp.ones(n, bool)

    levels = min(levels, len(prev_pyr))
    scale = 2.0 ** (levels - 1)
    if initial_flow is None:
        initial_flow = jnp.zeros_like(points)
    initial_flow = initial_flow.astype(points.dtype)

    def track_one(pt, d0, valid):
        d = d0 / scale
        ok_all = valid
        min_eig = jnp.array(jnp.inf, points.dtype)
        for lvl in range(levels - 1, -1, -1):
            lvl_scale = 2.0**lvl
            pt_lvl = pt / lvl_scale
            d, me, ok = _lk_level(
                prev_pyr[lvl], curr_pyr[lvl], pt_lvl, d, win, max_iters, eps
            )
            ok_all &= ok
            min_eig = jnp.minimum(min_eig, me)
            if lvl > 0:
                d = d * 2.0  # propagate to the next finer level

        new_pt = pt + d
        h, w = prev_pyr[0].shape
        in_bounds = (
            (new_pt[0] >= 0) & (new_pt[0] < w) & (new_pt[1] >= 0) & (new_pt[1] < h)
        )
        # Final window error at full resolution (cv2's `err` output).
        tmpl = _bilinear_window(prev_pyr[0], pt, win)
        curr = _bilinear_window(curr_pyr[0], new_pt, win)
        err = jnp.mean(jnp.abs(tmpl - curr))
        return new_pt, ok_all & in_bounds, err

    new_pts, status, err = jax.vmap(track_one)(points, initial_flow, point_mask)
    return FlowResult(new_pts, status, jnp.where(status, err, jnp.nan))
