"""Marker-free two-view reconstruction (BASELINE config 1 + north star).

The reference can only reconstruct with its calibration chessboard in view —
every pose comes from ``solvePnP`` on board corners (``processor.py:175-179``)
and there is no RANSAC of any kind. This module provides the classic
board-free path: ORB features -> exact Hamming matching as a matmul ->
batched-RANSAC essential matrix (thousands of 8-point hypotheses in one XLA
program, ``geometry/ransac.py``) -> cheirality-voted pose recovery -> DLT
triangulation of the inliers. Scale is unobservable from two views; the
returned translation is unit-norm and the cloud is up-to-scale.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu.geometry import projection, ransac, triangulation
from meatmodeler_tpu.ops import clahe, klt, matching, orb

__all__ = ["TwoViewResult", "reconstruct_two_view"]


class TwoViewResult(NamedTuple):
    points: jax.Array  # (M, 3) triangulated points (inlier slots valid)
    rvec: jax.Array  # (3,) axis-angle of camera 2 w.r.t. camera 1
    tvec: jax.Array  # (3,) unit-norm translation (scale unobservable)
    pts1: jax.Array  # (M, 2) matched pixels in view 1
    pts2: jax.Array  # (M, 2) matched pixels in view 2
    inliers: jax.Array  # (M,) bool: epipolar inlier AND in front of both cams
    num_inliers: jax.Array  # scalar int
    essential: jax.Array  # (3, 3)


def reconstruct_two_view(
    frame1,
    frame2,
    intrinsics,
    config: PipelineConfig = DEFAULT_CONFIG,
    key: Optional[jax.Array] = None,
    num_hypotheses: int = 2048,
    threshold: float = 1.5,
) -> TwoViewResult:
    """Reconstruct an up-to-scale cloud from two BGR frames and known K.

    All stages are device programs; the only host work is this function's
    orchestration. ``frame*`` may be (H, W, 3) BGR uint8 or (H, W) grey.
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    k = jnp.asarray(intrinsics, jnp.float32)

    def grey_of(f):
        f = jnp.asarray(f)
        if f.ndim == 3:
            return clahe.enhanced_grey(f[None])[0]
        return f.astype(jnp.float32)

    g1, g2 = grey_of(frame1), grey_of(frame2)

    feats = [
        orb.detect_and_compute(
            g,
            max_features=config.orb.num_features,
            num_levels=config.orb.num_levels,
            scale_factor=config.orb.scale_factor,
            fast_threshold=config.orb.fast_threshold,
            topk_recall=config.orb.topk_recall,
        )
        for g in (g1, g2)
    ]
    m = matching.match_descriptors(
        feats[0].descriptors,
        feats[1].descriptors,
        feats[0].mask,
        feats[1].mask,
        ratio=config.matcher.ratio,
        max_distance=config.matcher.max_distance,
        max_matches=config.matcher.max_matches,
        cross_check=config.matcher.cross_check,
    )
    pts1 = feats[0].xy[m.query_idx]
    pts2 = feats[1].xy[m.train_idx]

    # Polish correspondences to sub-pixel with single-level LK seeded at the
    # match offset: FAST/ORB keypoints localize only to ~1 px, which is fatal
    # for epipolar geometry on narrow baselines.
    pyr1 = tuple(klt.build_pyramid(g1, 1))
    pyr2 = tuple(klt.build_pyramid(g2, 1))
    flow = klt.lucas_kanade(
        pyr1,
        pyr2,
        pts1,
        win=15,
        levels=1,
        point_mask=m.mask,
        initial_flow=pts2 - pts1,
    )
    pts2 = jnp.where((flow.status & m.mask)[:, None], flow.points, pts2)

    rvec, tvec, res = ransac.estimate_relative_pose(
        pts1, pts2, m.mask, k, key, threshold=threshold, num_hypotheses=num_hypotheses
    )

    eye = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    ext2 = projection.extrinsics_from_params(jnp.concatenate([rvec, tvec])[None])[0]
    p1 = projection.projection_from_extrinsic(k, eye)
    p2 = projection.projection_from_extrinsic(k, ext2)
    pts3d = triangulation.triangulate_pairs(
        jnp.broadcast_to(p1, (pts1.shape[0], 3, 4)),
        jnp.broadcast_to(p2, (pts1.shape[0], 3, 4)),
        pts1,
        pts2,
    )
    # Cheirality: keep points in front of both cameras.
    z1 = pts3d[:, 2]
    c2 = projection.rotate_points(pts3d, rvec) + tvec
    in_front = (z1 > 0) & (c2[:, 2] > 0) & jnp.all(jnp.isfinite(pts3d), axis=1)
    inliers = res.inliers & in_front

    return TwoViewResult(
        points=jnp.where(inliers[:, None], pts3d, 0.0),
        rvec=rvec,
        tvec=tvec,
        pts1=pts1,
        pts2=pts2,
        inliers=inliers,
        num_inliers=jnp.sum(inliers),
        essential=res.matrix,
    )
