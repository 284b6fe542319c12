"""Full-calibration (reference-default) oracle parity: ``processor.py:49-53``.

The reference runs unconstrained ``cv2.calibrateCamera`` — both focals, free
principal point, all 5 distortion coefficients. The rebuild's pipeline
DEFAULTS constrain the problem (single focal, fixed principal point, 0 dist)
because the reference's own (4, 3) board is degenerate for the full mode
(config.py ChessboardConfig notes) — but the full mode is supported
(``calib_num_dist=5``, ``calib_single_focal=False``,
``calib_fix_principal_point=False``) and must match the cv2 oracle where the
problem IS well-posed: a large board spanning the FOV under strong tilts.

Scene: a 9x6 board, 14 views with +-35 deg tilts, corners synthesized by
``cv2.projectPoints`` from ground-truth K/dist5 with 0.05 px noise.
"""

import dataclasses

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from meatmodeler_tpu.geometry import calibration, distortion

PATTERN = (9, 6)  # inner corners (w, h)
K_TRUE = np.array([[800.0, 0.0, 310.0], [0.0, 790.0, 245.0], [0.0, 0.0, 1.0]])
DIST_TRUE = np.array([-0.28, 0.07, 0.0012, -0.0008, 0.015])
IMAGE_SIZE = (640, 480)


def _board_views(n_views=14, noise_px=0.05, seed=0):
    """(F, N, 2) corner pixels + (N, 3) object points, cv2-projected."""
    rng = np.random.default_rng(seed)
    w, h = PATTERN
    obj = np.zeros((w * h, 3))
    obj[:, 0] = np.tile(np.arange(w), h)
    obj[:, 1] = np.repeat(np.arange(h), w)

    views = []
    for i in range(n_views):
        # Strong, varied tilts: the axis the distortion/principal-point
        # observability needs (fronto-parallel-only views are degenerate).
        rx = np.deg2rad(rng.uniform(-35, 35))
        ry = np.deg2rad(rng.uniform(-35, 35))
        rz = np.deg2rad(rng.uniform(-15, 15))
        rvec = np.array([rx, ry, rz])
        # Board center ~origin; push it in front of the camera so the 8x5
        # board fills most of the 640x480 frame at f~800.
        tvec = np.array(
            [
                rng.uniform(-0.8, 0.8) - (w - 1) / 2.0,
                rng.uniform(-0.8, 0.8) - (h - 1) / 2.0,
                rng.uniform(11.0, 14.0),
            ]
        )
        pix, _ = cv2.projectPoints(obj, rvec, tvec, K_TRUE, DIST_TRUE)
        pix = pix.reshape(-1, 2) + rng.normal(0, noise_px, (len(obj), 2))
        views.append(pix)
    return np.stack(views), obj


@pytest.fixture(scope="module")
def board_data():
    return _board_views()


def _run_cv2(img_points, obj):
    rms, k, dist, _, _ = cv2.calibrateCamera(
        [obj.astype(np.float32)] * len(img_points),
        [v.astype(np.float32).reshape(-1, 1, 2) for v in img_points],
        IMAGE_SIZE,
        None,
        None,
    )
    return rms, k, dist.ravel()[:5]


def _dist_curve_max_px(dist_a, dist_b, focal=800.0, r_max=0.45):
    """Max |distortion-model difference| in px over the board's radial range.

    Applies both 5-coefficient models to a grid of normalized points
    covering the views' extent and reports the worst pixel-space gap.
    """
    g = np.linspace(-r_max, r_max, 21)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    da = np.asarray(distortion.distort_normalized(jnp.asarray(xy), jnp.asarray(dist_a)))
    db = np.asarray(distortion.distort_normalized(jnp.asarray(xy), jnp.asarray(dist_b)))
    return float(np.abs(da - db).max() * focal)


class TestFullCalibrationParity:
    """processor.py:49-53: unconstrained calibrateCamera equivalence."""

    def test_full_mode_matches_cv2_and_truth(self, board_data):
        img_points, obj = board_data
        res = calibration.calibrate(
            jnp.asarray(img_points),
            jnp.asarray(obj),
            jnp.asarray(IMAGE_SIZE, jnp.float64),
            num_dist=5,
            single_focal=False,
            fix_principal_point=False,
        )
        k_ours = np.asarray(res.intrinsics)
        dist_ours = np.asarray(res.dist)

        rms_cv, k_cv, dist_cv = _run_cv2(img_points, obj)

        # Intrinsics within 1% of ground truth AND of the cv2 oracle.
        for k_ref, label in ((K_TRUE, "truth"), (k_cv, "cv2")):
            for (i, j) in ((0, 0), (1, 1), (0, 2), (1, 2)):
                assert abs(k_ours[i, j] - k_ref[i, j]) / abs(k_ref[i, j]) < 0.01, (
                    f"K[{i},{j}] vs {label}: ours {k_ours[i, j]:.2f} "
                    f"ref {k_ref[i, j]:.2f}"
                )

        # Distortion CURVES (not raw coefficients — k1/k2/k3 trade off along
        # a near-null direction; the curve is the observable) within a
        # fraction of a pixel of truth and of cv2 across the board's extent.
        assert _dist_curve_max_px(dist_ours, DIST_TRUE) < 0.25
        assert _dist_curve_max_px(dist_ours, dist_cv) < 0.25

        # Reprojection RMS in the same band as the oracle's (both ~noise).
        assert float(res.rms) < max(2.0 * rms_cv, 0.15)

    def test_config_plumbs_full_mode(self):
        """The OpenCV-equivalent configuration claimed at config.py
        (ChessboardConfig.calib_*) constructs and carries the full mode."""
        from meatmodeler_tpu.config import ChessboardConfig

        cfg = ChessboardConfig(
            calib_num_dist=5,
            calib_single_focal=False,
            calib_fix_principal_point=False,
        )
        assert cfg.calib_num_dist == 5
        assert not cfg.calib_single_focal
        assert not cfg.calib_fix_principal_point
