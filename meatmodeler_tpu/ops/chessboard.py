"""Chessboard detection (host) + sub-pixel corner refinement (device).

Detection keeps host OpenCV per SURVEY.md §7.3.5 ("genuinely hard to do well
on-device; per-keyframe and cheap") — call sites ``processor.py:315, 319,
369``. The more robust ``findChessboardCornersSB`` is preferred, falling back
to the classic detector; a missing cv2 degrades gracefully (detection
returns None, and callers that have ground-truth corners — e.g. synthetic
benchmarks — can inject them).

Sub-pixel refinement replaces ``cv2.cornerSubPix`` (``processor.py:168-172``)
with a ``vmap``-batched JAX solver: iterate q <- (sum w g g^T)^-1 (sum w g
g^T p) over a window of image gradients — the classic orthogonality condition
(each window pixel's gradient is orthogonal to q - p at a true corner).
The reference refines **all frames' corners in a Python loop, in place**
(SURVEY.md §2.1 poseEstimation); here every corner of every keyframe refines
in one program.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "find_chessboard",
    "canonicalize_corners",
    "orient_corners_to",
    "refine_corners_subpix",
]


def orient_corners_to(corners: np.ndarray, prev: Optional[np.ndarray]) -> np.ndarray:
    """Resolve the board's 180-degree ambiguity consistently across frames.

    A plain chessboard maps onto itself under a 180-degree rotation, so
    detectors may return the grid traversed from either end — and they DO
    flip between frames (the classic detector especially). A flip changes
    the 2D-3D correspondence and silently wrecks pose estimation, while
    staying perfectly planar (invisible to the homography gate). Anchor each
    detection to the previous keyframe's corners: the board moves by a few
    pixels between keyframes, so the correct orientation is the one whose
    endpoints stay near the previous endpoints. The first frame's choice is
    arbitrary — a global 180-degree rotation of the world frame is rigid.
    """
    c = np.asarray(corners, np.float32)
    if prev is None:
        return c
    keep = np.linalg.norm(c[0] - prev[0]) + np.linalg.norm(c[-1] - prev[-1])
    flip = np.linalg.norm(c[0] - prev[-1]) + np.linalg.norm(c[-1] - prev[0])
    if flip < keep:
        # 180-degree grid rotation = full reversal in flat row-major order
        # (reverses rows and columns together, preserving the winding).
        return np.ascontiguousarray(c[::-1])
    return c


def canonicalize_corners(corners: np.ndarray, pattern: Tuple[int, int]) -> np.ndarray:
    """Fix the detector's grid traversal to a consistent winding.

    ``findChessboardCorners[SB]`` may return the row-major grid mirrored
    (each row reversed), which is an *improper* relabeling of the planar
    target: PnP then resolves it as viewing the board from the back and the
    whole world frame comes out y-flipped (the reconstructed item lands
    "below" the board). The reference inherits whatever cv2 returns
    (``processor.py:369-373``) and would reconstruct into that flipped frame.

    Canonical rule: the in-image cross product (along-row x along-column)
    must be negative — which, for the X-Z board layout
    (``processor.py:162-166``), places every camera on the y < 0 side
    ("above" the board). A wrong winding is fixed by reversing each row
    (the remaining 180-degree ambiguity is a rigid rotation: harmless).
    """
    cols, rows = pattern
    c = np.asarray(corners, np.float32).reshape(rows, cols, 2)
    v_row = c[0, -1] - c[0, 0]
    v_col = c[-1, 0] - c[0, 0]
    cross = v_row[0] * v_col[1] - v_row[1] * v_col[0]
    if cross > 0:
        c = c[:, ::-1]
    return c.reshape(-1, 2)


def host_detector_available() -> bool:
    """Whether OpenCV, which ``find_chessboard`` runs, can be imported."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def find_chessboard(
    grey: np.ndarray, pattern: Tuple[int, int], fast_probe: bool = False
) -> Optional[np.ndarray]:
    """Detect inner corners on the host with OpenCV. Returns (N, 2) float32,
    or None when no board is found. Raises ImportError without OpenCV:
    callers check ``host_detector_available`` and use the on-device detector
    (``ops/board_detect.py``) instead.

    Corner order matches OpenCV's (row-major over the pattern), which the
    calibration/pose stages rely on for 2D-3D correspondence.

    ``fast_probe=True`` adds CALIB_CB_FAST_CHECK and skips the SB fallback:
    a cheap is-there-a-board-at-all probe for the bootstrap hunt over
    board-free leading frames (a full no-board detect costs seconds per
    1080p frame, nearly all of it in the SB fallback; the fast check
    rejects in milliseconds). Probe callers must keep a full-detector
    safety net — FAST_CHECK can false-negative small or blurred boards.
    """
    import cv2

    img = np.ascontiguousarray(np.clip(np.asarray(grey), 0, 255).astype(np.uint8))
    if fast_probe:
        ok, corners = cv2.findChessboardCorners(
            img,
            pattern,
            flags=cv2.CALIB_CB_ADAPTIVE_THRESH
            | cv2.CALIB_CB_NORMALIZE_IMAGE
            | cv2.CALIB_CB_FAST_CHECK,
        )
        if not ok:
            return None
        return corners.reshape(-1, 2).astype(np.float32)
    # Classic detector first: it is ~10x faster than findChessboardCornersSB
    # and its lower corner precision is irrelevant here — callers refine to
    # sub-pixel on device afterwards (refine_corners_subpix) and validate
    # the grid against a planar homography fit. SB is the robust fallback.
    ok, corners = cv2.findChessboardCorners(img, pattern)
    if not ok:
        ok, corners = cv2.findChessboardCornersSB(img, pattern)
    if not ok:
        return None
    return corners.reshape(-1, 2).astype(np.float32)


def _grad_window(img, center, win):
    """Bilinearly sampled intensity window + central-difference gradients.

    One dynamic_slice block load + four shifted views (no per-pixel
    gather under vmap), same scheme as ``ops.klt._bilinear_window``.
    """
    size = win + 2  # +1 ring for the central differences
    half = (size - 1) / 2.0
    pad = size + 1  # edge-pad: border windows sample padding, never shift
    img = jnp.pad(img, pad, mode="edge")
    h, w = img.shape
    tl = center - half + pad
    t0 = jnp.floor(tl)
    fx = tl[0] - t0[0]
    fy = tl[1] - t0[1]
    x0 = jnp.clip(t0[0].astype(jnp.int32), 0, w - size - 1)
    y0 = jnp.clip(t0[1].astype(jnp.int32), 0, h - size - 1)
    big = jax.lax.dynamic_slice(img, (y0, x0), (size + 1, size + 1))
    v = (
        big[:-1, :-1] * (1 - fy) * (1 - fx)
        + big[:-1, 1:] * (1 - fy) * fx
        + big[1:, :-1] * fy * (1 - fx)
        + big[1:, 1:] * fy * fx
    )
    gx = (v[1:-1, 2:] - v[1:-1, :-2]) * 0.5
    gy = (v[2:, 1:-1] - v[:-2, 1:-1]) * 0.5
    return gx, gy


@partial(jax.jit, static_argnames=("win", "iters"))
def refine_corners_subpix(
    img: jax.Array,
    corners: jax.Array,
    win: int = 11,
    iters: int = 30,
    eps: float = 1e-3,
) -> jax.Array:
    """Refine corners to sub-pixel accuracy (cv2.cornerSubPix semantics:
    11x11 window, 30 iters, eps 1e-3 — ``processor.py:168-172``).

    Args:
      img: (H, W) grey image.
      corners: (N, 2) float (x, y) initial corner estimates.

    Returns:
      (N, 2) refined corners.
    """
    img = jnp.asarray(img)
    corners = jnp.asarray(corners, img.dtype)
    half = win // 2
    dy = jnp.arange(-half, half + 1, dtype=img.dtype)
    dx = jnp.arange(-half, half + 1, dtype=img.dtype)
    # OpenCV's window weighting: separable (1 - (d/(half+1))^2)-style taper;
    # a Gaussian taper is numerically equivalent for parity at this scale.
    wy = jnp.exp(-((dy / (half + 1.0)) ** 2) * 2.0)
    wx = jnp.exp(-((dx / (half + 1.0)) ** 2) * 2.0)
    weight = wy[:, None] * wx[None, :]
    offs_x = jnp.broadcast_to(dx[None, :], (win, win))
    offs_y = jnp.broadcast_to(dy[:, None], (win, win))

    def refine_one(q0):
        def body(_, q):
            gx, gy = _grad_window(img, q, win)
            gxx = jnp.sum(weight * gx * gx)
            gxy = jnp.sum(weight * gx * gy)
            gyy = jnp.sum(weight * gy * gy)
            bx = jnp.sum(weight * (gx * gx * offs_x + gx * gy * offs_y))
            by = jnp.sum(weight * (gx * gy * offs_x + gy * gy * offs_y))
            det = gxx * gyy - gxy * gxy
            ok = jnp.abs(det) > 1e-12
            inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
            delta = jnp.stack(
                [
                    (gyy * bx - gxy * by) * inv_det,
                    (gxx * by - gxy * bx) * inv_det,
                ]
            )
            small = jnp.sum(delta * delta) < eps * eps
            return jnp.where(small | ~ok, q, q + delta)

        return jax.lax.fori_loop(0, iters, body, q0)

    return jax.vmap(refine_one)(corners)
