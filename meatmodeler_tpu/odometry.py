"""Marker-free visual odometry: KLT tracking + incremental pose chaining.

BASELINE config 2 ("multi-frame KLT tracking + incremental pose chaining
over a sequence"). The reference has no such capability — every pose it
produces requires the calibration chessboard in view (``processor.py:
175-179``). Here consecutive frames are linked by pyramidal LK tracking
(sub-pixel correspondences, far better conditioned than descriptor matches),
each step's relative pose comes from the batched LO-RANSAC essential
estimator (``geometry/ransac.py``), and the unobservable per-step monocular
scale is propagated by 3-frame depth consistency: points tracked across
(k-1, k, k+1) are triangulated in both adjacent pairs and the median depth
ratio fixes step k+1's translation magnitude relative to step k's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu.geometry import projection, ransac, so3, triangulation
from meatmodeler_tpu.ops import clahe, features, klt

__all__ = ["OdometryResult", "chain_poses"]


class OdometryResult(NamedTuple):
    poses: np.ndarray  # (T, 6) world-to-camera [rvec, tvec]; frame 0 = identity
    num_inliers: np.ndarray  # (T,) epipolar inliers per step (0 for frame 0)
    num_tracked: np.ndarray  # (T,) KLT survivors per step
    scales: np.ndarray  # (T,) translation magnitude applied per step


def _compose(pose_a: np.ndarray, rvec_rel, tvec_rel) -> np.ndarray:
    """world->cam_b from world->cam_a and cam_a->cam_b."""
    r_a = np.asarray(so3.exp(jnp.asarray(pose_a[:3])))
    r_rel = np.asarray(so3.exp(jnp.asarray(rvec_rel)))
    r_b = r_rel @ r_a
    t_b = r_rel @ pose_a[3:] + np.asarray(tvec_rel)
    return np.concatenate([np.asarray(so3.log(jnp.asarray(r_b))), t_b])


def chain_poses(
    frames,
    intrinsics,
    config: PipelineConfig = DEFAULT_CONFIG,
    key: Optional[jax.Array] = None,
    min_tracks: int = 40,
    num_hypotheses: int = 1024,
) -> OdometryResult:
    """Chain camera poses through a sequence without any calibration target.

    Args:
      frames: (T, H, W[, 3]) uint8 frames or a FrameSource-compatible array.
      intrinsics: (3, 3) K (calibrate separately or reuse a prior run's).
      config: keyframe block supplies the Shi-Tomasi/KLT parameters.
      min_tracks: reseed features when the live track count drops below this.
      num_hypotheses: RANSAC hypotheses per step.

    Returns:
      OdometryResult with frame-0-anchored world-to-camera poses. The global
      scale is set by the FIRST step's unit translation (monocular gauge);
      subsequent steps are scaled consistently to it.
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    k = jnp.asarray(intrinsics, jnp.float32)
    kf = config.keyframe
    frames = np.asarray(frames)
    t_total = len(frames)

    def grey_of(i):
        f = jnp.asarray(frames[i])
        if f.ndim == 3:
            return clahe.enhanced_grey(f[None])[0]
        return clahe.clahe(f.astype(jnp.float32)).astype(jnp.float32)

    def seed(grey):
        c = features.good_features(
            grey,
            max_corners=kf.max_corners,
            quality_level=kf.quality_level,
            min_distance=kf.min_distance,
            block_size=kf.block_size,
        )
        return c.xy, c.mask

    poses = [np.zeros(6, np.float32)]
    inliers_per = [0]
    tracked_per = [0]
    scales = [0.0]

    prev_grey = grey_of(0)
    prev_pyr = tuple(klt.build_pyramid(prev_grey, kf.pyramid_levels))
    pts, mask = seed(prev_grey)
    # Previous step's triangulated depths for scale chaining: map from point
    # slot -> depth in the PREVIOUS camera frame (NaN = unavailable).
    prev_depth = np.full(pts.shape[0], np.nan, np.float32)
    prev_scale = 1.0

    for t in range(1, t_total):
        cur_grey = grey_of(t)
        cur_pyr = tuple(klt.build_pyramid(cur_grey, kf.pyramid_levels))
        flow = klt.lucas_kanade(
            prev_pyr,
            cur_pyr,
            pts,
            win=kf.window,
            levels=kf.pyramid_levels,
            max_iters=kf.max_iters,
            eps=kf.eps,
            point_mask=mask,
        )
        good = np.asarray(mask & flow.status)
        tracked_per.append(int(good.sum()))

        step_key = jax.random.fold_in(key, t)
        rvec, tvec, res = ransac.estimate_relative_pose(
            pts,
            flow.points,
            jnp.asarray(good),
            k,
            step_key,
            num_hypotheses=num_hypotheses,
        )
        inl = np.asarray(res.inliers)
        inliers_per.append(int(inl.sum()))

        # Triangulate this pair (unit translation) to get current depths.
        eye = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
        ext2 = projection.extrinsics_from_params(
            jnp.concatenate([rvec, tvec])[None]
        )[0]
        pts3d = triangulation.triangulate_pairs(
            jnp.broadcast_to(
                projection.projection_from_extrinsic(k, eye), (pts.shape[0], 3, 4)
            ),
            jnp.broadcast_to(
                projection.projection_from_extrinsic(k, ext2), (pts.shape[0], 3, 4)
            ),
            pts,
            flow.points,
        )
        depth_cur = np.asarray(pts3d[:, 2])  # depth in camera t-1's frame
        ok_depth = inl & np.isfinite(depth_cur) & (depth_cur > 1e-3)

        # Scale chaining: slots with a depth from the previous pair give the
        # ratio between the previous step's metric frame and this pair's
        # unit-translation frame.
        both = ok_depth & np.isfinite(prev_depth)
        if both.sum() >= 8:
            # prev_depth is already in the global gauge; the ratio converts
            # this pair's unit-translation gauge straight to global units.
            scale = float(np.median(prev_depth[both] / depth_cur[both]))
        else:
            scale = prev_scale  # fall back: assume constant speed
        scales.append(scale)

        poses.append(_compose(poses[-1], np.asarray(rvec), np.asarray(tvec) * scale))

        # Depths of the CURRENT camera (t) for the next step's chaining:
        # transform the pair triangulation into camera t's frame and rescale
        # to the global gauge.
        cam_t = (np.asarray(ext2[:3, :3]) @ np.asarray(pts3d).T).T + np.asarray(
            ext2[:3, 3]
        )
        new_depth = np.where(ok_depth, cam_t[:, 2] * scale, np.nan).astype(np.float32)

        pts_next = flow.points
        mask_next = jnp.asarray(good)
        if int(good.sum()) < min_tracks:
            pts_next, mask_next = seed(cur_grey)
            new_depth = np.full(pts_next.shape[0], np.nan, np.float32)

        prev_grey, prev_pyr = cur_grey, cur_pyr
        pts, mask = pts_next, mask_next
        prev_depth = new_depth
        prev_scale = scale

    return OdometryResult(
        poses=np.stack(poses),
        num_inliers=np.asarray(inliers_per),
        num_tracked=np.asarray(tracked_per),
        scales=np.asarray(scales, np.float32),
    )
