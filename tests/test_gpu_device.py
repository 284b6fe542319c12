"""On-device test subset: the paths whose correctness a CPU run cannot show,
compiled by XLA for the GPU and run on the card.

Run with the card visible (``chip_smoke.py`` runs this subset in its own
process, so that one JAX process holds the card):

    MEATMODELER_GPU_TESTS=1 python -m pytest tests/test_gpu_device.py -m gpu -q

Normal runs exclude these (pyproject addopts ``-m 'not gpu'``), and the
``gpu`` fixture skips every test with a reason when JAX finds no GPU, as in
the CPU suite (the conftest forces the CPU backend unless
``MEATMODELER_GPU_TESTS=1``).
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py on the card)")
    return jax.devices()[0]


class TestRuntimeOnDevice:
    def test_device_barrier_drains_the_stream(self, gpu):
        """utils.profiling.device_barrier: one trivial blocked op waits for
        everything dispatched before it (one in-order compute stream)."""
        import jax
        import jax.numpy as jnp

        from meatmodeler_tpu.utils.profiling import device_barrier

        @jax.jit
        def heavy(x):
            for _ in range(16):
                x = jnp.tanh(x @ x) * 0.5
            return x

        x = jnp.ones((4096, 4096), jnp.float32) / 4096.0
        heavy(x).block_until_ready()  # compile outside the check
        y = heavy(x)
        device_barrier()
        assert y.is_ready()

    def test_clahe_matches_cpu(self, gpu):
        """ops.clahe on the card vs the same function on the CPU backend:
        the LUTs are integer-exact, the bilinear apply is float."""
        import jax

        from meatmodeler_tpu.ops import clahe

        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, size=(2, 300, 400)).astype(np.float32)
        served = np.asarray(clahe.clahe(jax.device_put(img, gpu)))
        cpu = jax.devices("cpu")[0]
        ref = np.asarray(clahe.clahe(jax.device_put(img, cpu)))
        np.testing.assert_allclose(served, ref, atol=1e-3)


class TestApproxTopKOnDevice:
    def test_good_features_oversampled_ranking_sane(self, gpu):
        """approx_max_k vs exact lax.top_k on the card: the oversampled path must recover the exact top
        corners (identical positions as sets) on a structured image."""
        import jax.numpy as jnp

        from meatmodeler_tpu.ops import features

        rng = np.random.default_rng(2)
        img = rng.uniform(0, 30, size=(240, 320)).astype(np.float32)
        # Plant strong corners on a grid.
        for y in range(20, 240, 30):
            for x in range(20, 320, 30):
                img[y : y + 6, x : x + 6] = 255.0 * ((y // 30 + x // 30) % 2)
        img_j = jnp.asarray(img)
        approx = features.good_features(img_j, max_corners=64)
        exact = features.good_features(img_j, max_corners=64, exact_topk=True)
        a = {tuple(p) for p, m in zip(np.asarray(approx.xy), np.asarray(approx.mask)) if m}
        e = {tuple(p) for p, m in zip(np.asarray(exact.xy), np.asarray(exact.mask)) if m}
        # Oversampled approx ranking: identical corner SET (ordering may
        # differ inside response ties).
        assert len(e) > 16
        assert len(a & e) >= 0.9 * len(e), (len(a & e), len(e))


class TestMatchingOnDevice:
    def test_hamming_matmul_exact(self, gpu):
        """The bf16 Hamming matmul must be EXACT (256-long {0,1} dots are
        integers <= 256, accumulated in f32)."""
        import jax.numpy as jnp

        from meatmodeler_tpu.ops.matching import hamming_matrix

        rng = np.random.default_rng(3)
        q = rng.integers(0, 2, size=(512, 256)).astype(np.int8)
        t = rng.integers(0, 2, size=(512, 256)).astype(np.int8)
        d = np.asarray(hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
        ref = (q[:, None, :] != t[None, :, :]).sum(-1)
        np.testing.assert_array_equal(d.astype(np.int32), ref)


def _ring_problem(n_f=8, n_p=256, noise_px=0.5, seed=0):
    """Synthetic ring-of-cameras BA problem with ground truth (all numpy)."""
    import jax.numpy as jnp

    from meatmodeler_tpu.geometry import projection, so3

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_p, 3)).astype(np.float32)
    params = []
    for i in range(n_f):
        ang = 0.6 * i / n_f - 0.3
        rvec = np.array([0.0, ang, 0.0], np.float32)
        r = np.asarray(so3.exp(jnp.asarray(rvec)))
        c = np.array([10.0 * np.sin(ang), 0.5, -10.0 * np.cos(ang)], np.float32)
        t = -r @ c
        params.append(np.concatenate([rvec, t]))
    params = np.stack(params).astype(np.float32)
    k = np.array([[500.0, 0, 200], [0, 500.0, 150], [0, 0, 1]], np.float32)
    ext = np.asarray(projection.extrinsics_from_params(jnp.asarray(params)))
    projm = np.asarray(
        projection.projection_from_extrinsic(jnp.asarray(k), jnp.asarray(ext))
    )
    ph = np.concatenate([pts, np.ones((n_p, 1), np.float32)], 1)
    uvw = np.einsum("fij,pj->fpi", projm, ph)
    uv = uvw[..., :2] / uvw[..., 2:3]
    fidx = np.repeat(np.arange(n_f, dtype=np.int32), n_p)
    pidx = np.tile(np.arange(n_p, dtype=np.int32), n_f)
    obs = uv.reshape(-1, 2) + rng.normal(0, noise_px, (n_f * n_p, 2)).astype(
        np.float32
    )
    return dict(
        pts=pts, params=params, k=k, ext=ext, obs=obs, fidx=fidx, pidx=pidx
    )


class TestSolversOnDevice:
    """The LM/Schur solver programs on the card, where float32 matmuls
    default to TF32 unless utils.precision pins them."""

    def test_global_ba_converges_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.solvers import bundle_adjust

        prob = _ring_problem()
        rng = np.random.default_rng(1)
        pts0 = prob["pts"] + rng.normal(0, 0.05, prob["pts"].shape).astype(
            np.float32
        )
        new_pts, ext4, res = bundle_adjust.adjust_points(
            jnp.asarray(prob["ext"]),
            jnp.asarray(prob["k"]),
            jnp.asarray(pts0),
            jnp.asarray(prob["obs"]),
            jnp.asarray(prob["fidx"]),
            jnp.asarray(prob["pidx"]),
        )
        rmse = float(res.rmse)
        assert np.isfinite(rmse) and rmse < 0.8, rmse  # ~noise level
        assert np.isfinite(np.asarray(new_pts)).all()
        # Refined points must beat the perturbed init against ground truth.
        err0 = np.linalg.norm(pts0 - prob["pts"], axis=1).mean()
        err1 = np.linalg.norm(np.asarray(new_pts) - prob["pts"], axis=1).mean()
        assert err1 < err0

    def test_pose_ba_recovers_perturbation_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import projection
        from meatmodeler_tpu.solvers import bundle_adjust

        # Board poses: exact corner observations, perturbed extrinsic init.
        from meatmodeler_tpu.geometry.calibration import chessboard_object_points

        pattern, side = (4, 3), 2.0
        rng = np.random.default_rng(2)
        prob = _ring_problem(n_f=6)
        k = prob["k"]
        board_xz = np.zeros((12, 3), np.float32)
        grid = np.asarray(chessboard_object_points(pattern))
        board_xz[:, 0] = grid[:, 0] * side
        board_xz[:, 2] = grid[:, 1] * side
        ph = np.concatenate([board_xz, np.ones((12, 1), np.float32)], 1)
        projm = np.asarray(
            projection.projection_from_extrinsic(
                jnp.asarray(k), jnp.asarray(prob["ext"])
            )
        )[:6]
        uvw = np.einsum("fij,pj->fpi", projm, ph)
        obs = (uvw[..., :2] / uvw[..., 2:3]).reshape(-1, 2)
        params0 = prob["params"][:6] + rng.normal(0, 0.01, (6, 6)).astype(
            np.float32
        )
        ext0 = np.asarray(
            projection.extrinsics_from_params(jnp.asarray(params0))
        )
        ext_ref, res = bundle_adjust.adjust_pose(
            jnp.asarray(ext0), jnp.asarray(k), jnp.asarray(obs),
            pattern=pattern, side_length=side,
        )
        assert float(res.rmse) < 0.05  # exact observations -> ~0 residual
        np.testing.assert_allclose(
            np.asarray(ext_ref), prob["ext"][:6], atol=5e-3
        )


class TestGeometryOnDevice:
    def test_so3_roundtrip_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import so3

        rng = np.random.default_rng(3)
        # |v| <= sqrt(3) < pi keeps the log branch-unambiguous.
        v = rng.uniform(-1.0, 1.0, (4, 3)).astype(np.float32)
        r = jnp.stack([so3.exp(jnp.asarray(x)) for x in v])
        back = np.stack([np.asarray(so3.log(r[i])) for i in range(4)])
        np.testing.assert_allclose(back, v, atol=1e-5)

    def test_nview_triangulation_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import projection, triangulation

        prob = _ring_problem(n_p=64, noise_px=0.0)
        projm = projection.projection_from_extrinsic(
            jnp.asarray(prob["k"]), jnp.asarray(prob["ext"])
        )
        coords = prob["obs"].reshape(len(prob["ext"]), 64, 2).transpose(1, 0, 2)
        om = np.ones((64, len(prob["ext"])), bool)
        pts = triangulation.triangulate_nview(
            projm, jnp.asarray(coords), jnp.asarray(om)
        )
        np.testing.assert_allclose(np.asarray(pts), prob["pts"][:64], atol=2e-2)

    def test_ransac_relative_pose_on_device(self, gpu):
        import jax

        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import ransac, so3

        prob = _ring_problem(n_f=2, n_p=512, noise_px=0.3, seed=5)
        uv = prob["obs"].reshape(2, 512, 2)
        rvec, tvec, res = ransac.estimate_relative_pose(
            jnp.asarray(uv[0]),
            jnp.asarray(uv[1]),
            jnp.ones(512, bool),
            jnp.asarray(prob["k"]),
            jax.random.PRNGKey(0),
        )
        # True relative rotation between the two ring cameras.
        r0, r1 = prob["ext"][0][:3, :3], prob["ext"][1][:3, :3]
        r_rel_true = r1 @ r0.T
        r_est = np.asarray(so3.exp(jnp.asarray(rvec)))
        ang_err = np.rad2deg(
            np.arccos(np.clip((np.trace(r_est @ r_rel_true.T) - 1) / 2, -1, 1))
        )
        assert ang_err < 1.0, ang_err
        assert int(np.asarray(res.inliers).sum()) > 300

    def test_calibration_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import calibration

        from meatmodeler_tpu.geometry import so3

        # Well-posed 9x6 board, 8 tilted views, no noise; f32 on device.
        rng = np.random.default_rng(6)
        k_true = np.array(
            [[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float64
        )
        obj = np.zeros((54, 3))
        obj[:, 0] = np.tile(np.arange(9), 6)
        obj[:, 1] = np.repeat(np.arange(6), 9)
        views = []
        for _ in range(8):
            rvec = np.deg2rad(rng.uniform(-30, 30, 3) * [1, 1, 0.4])
            tvec = np.array(
                [rng.uniform(-1, 1) - 4, rng.uniform(-1, 1) - 2.5,
                 rng.uniform(10, 13)]
            )
            r = np.asarray(so3.exp(np.asarray(rvec, np.float32)), np.float64)
            cam = obj @ r.T + tvec
            pix = cam @ k_true.T
            views.append(pix[:, :2] / pix[:, 2:3])
        res = calibration.calibrate(
            jnp.asarray(np.stack(views), jnp.float32),
            jnp.asarray(obj, jnp.float32),
            jnp.asarray([640.0, 480.0], jnp.float32),
            num_dist=0,
        )
        k = np.asarray(res.intrinsics)
        assert abs(k[0, 0] - 600.0) / 600.0 < 0.01, k
        assert float(res.rms) < 0.2


class TestOpsOnDevice:
    def test_klt_recovers_known_shift_on_device(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.ops import features, klt

        rng = np.random.default_rng(7)
        base = rng.uniform(0, 255, (256, 320)).astype(np.float32)
        # Smooth the noise so LK's linearization holds.
        import scipy.ndimage as ndi

        base = ndi.gaussian_filter(base, 3.0) * 8
        dx, dy = 3.25, -2.5
        shifted = ndi.shift(base, (dy, dx), order=3, mode="nearest")
        corners = features.good_features(jnp.asarray(base), max_corners=64)
        pyr_a = tuple(klt.build_pyramid(jnp.asarray(base), 3))
        pyr_b = tuple(klt.build_pyramid(jnp.asarray(shifted), 3))
        flow = klt.lucas_kanade(
            pyr_a, pyr_b, corners.xy, win=15, levels=3, max_iters=20,
            eps=0.001, point_mask=corners.mask,
        )
        ok = np.asarray(corners.mask & flow.status)
        d = np.asarray(flow.points - corners.xy)[ok]
        # Median flow within 0.2 px of the injected shift.
        assert ok.sum() > 20
        np.testing.assert_allclose(
            np.median(d, axis=0), [dx, dy], atol=0.2
        )

    def test_board_detect_on_device_matches_truth(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
        from meatmodeler_tpu.ops import chessboard, color
        from meatmodeler_tpu.ops.board_detect import find_chessboard_device

        scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)
        frames, _, truth = render_sequence(scene, 2, seed=0)
        grey = color.bgr_to_grey(jnp.asarray(frames[0], jnp.float32))
        det = find_chessboard_device(grey)
        assert bool(det.ok)
        ours = chessboard.canonicalize_corners(np.asarray(det.corners), (4, 3))
        ref = chessboard.canonicalize_corners(np.asarray(truth[0], np.float32), (4, 3))
        # Same 12 corners as the renderer's projected truth, each within
        # 1.5 px (either row order: the grid is symmetric).
        d_fwd = np.abs(ours - ref).max()
        d_rev = np.abs(ours[::-1] - ref).max()
        assert min(d_fwd, d_rev) < 1.5, (d_fwd, d_rev)


class TestVolumeOnDevice:
    def test_hull_and_carve_on_ellipsoid_cloud(self, gpu):
        import jax.numpy as jnp

        from meatmodeler_tpu.geometry import projection
        from meatmodeler_tpu import volume as volume_mod

        # Dense ellipsoid surface cloud + a ring of cameras; the hull
        # estimate must land near the analytic volume.
        rng = np.random.default_rng(8)
        axes = np.array([2.0, 1.5, 1.8])
        u = rng.normal(size=(2048, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts = (u * axes).astype(np.float32)
        prob = _ring_problem(n_f=8)
        projm = projection.projection_from_extrinsic(
            jnp.asarray(prob["k"]), jnp.asarray(prob["ext"])
        )
        hull, carve = volume_mod.hull_and_carved_volume(
            jnp.asarray(pts),
            jnp.ones(2048, bool),
            projm,
            jnp.ones(8, bool),
            image_size=(400, 300),
            resolution=64,
            trim=3,
        )
        truth = 4.0 / 3.0 * np.pi * axes.prod()
        assert abs(float(hull) - truth) / truth < 0.25, (float(hull), truth)
        assert np.isfinite(float(carve))

    def test_view_regime_predictors_on_device(self, gpu):
        """eigvalsh + the arc reduction compile and read sanely on the card
        (the volume-confidence flag rides these — pipeline _view_regime)."""
        import jax.numpy as jnp

        from meatmodeler_tpu.pipeline import _view_regime

        rng = np.random.default_rng(9)
        prob = _ring_problem(n_f=8)
        # Elongated cloud, 3:1 aspect.
        pts = rng.normal(size=(512, 3)).astype(np.float32) * [3.0, 1.0, 1.0]
        out = np.asarray(
            _view_regime(
                jnp.asarray(prob["ext"]),
                jnp.ones(8, bool),
                jnp.asarray(pts),
                jnp.ones(512, bool),
            )
        )
        arc_deg, elong = float(out[0]), float(out[1])
        # The ring spans 0.6 rad ~ 34 deg; elongation ~3.
        assert 20.0 < arc_deg < 50.0, arc_deg
        assert 2.0 < elong < 4.0, elong


class TestTinyEndToEndOnDevice:
    def test_small_clip_reconstructs(self, gpu, tmp_path):
        """One tiny e2e on the card: 16 frames at 400x300 through the
        full pipeline (board detect, ORB, matching, calibration, BA, volume)."""
        from meatmodeler_tpu.config import (
            DEFAULT_CONFIG,
            KeyframeConfig,
            MatcherConfig,
            OrbConfig,
            TrackConfig,
            VolumeConfig,
        )
        from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
        from meatmodeler_tpu.pipeline import process

        cfg = dataclasses.replace(
            DEFAULT_CONFIG,
            keyframe=dataclasses.replace(
                KeyframeConfig(), max_corners=256, threshold=0.02
            ),
            orb=OrbConfig(num_features=768, num_levels=2),
            matcher=MatcherConfig(max_matches=512),
            tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
            volume=VolumeConfig(voxel_resolution=48),
            frame_chunk=8,
        )
        scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
        frames, _, _ = render_sequence(scene, 16, seed=0)
        result = process(frames, path=str(tmp_path / "run"), config=cfg)
        assert np.isfinite(result.reprojection_rmse)
        assert result.reprojection_rmse < 2.0
        assert len(result.points) > 30
        assert abs(result.intrinsics[0, 0] - scene.focal) / scene.focal < 0.08


class TestVolumeSplitOnDevice:
    def test_split_item_points_matches_cpu(self, gpu):
        """Device item split == CPU item split on a realistic-magnitude
        cloud. The k-NN density gate's |p|^2-expansion is catastrophically
        cancellation-prone, and a reduced-precision default matmul (TF32 on
        the card) corrupts the split unless split_item_points is pinned to
        HIGHEST precision."""
        import jax
        import jax.numpy as jnp

        from meatmodeler_tpu import volume

        rng = np.random.default_rng(11)
        # Item surface ~ the bench scene's magnitudes: centroid ~ (-5, -2, 3),
        # |p| ~ 6-25, k-NN spacing ~ 0.05-0.3 — the regime where TF32
        # matmul noise (~0.05% relative of |p|^2) swamps true neighbour
        # distances.
        v = rng.normal(size=(1200, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        item = (v * np.array([2.0, 1.5, 1.8]) + np.array([-5.2, -2.2, 3.0]))
        sheet = np.column_stack([
            rng.uniform(-8, 10, 700), np.zeros(700), rng.uniform(-4, 26, 700),
        ])
        outliers = rng.normal(size=(20, 3)) * 8 + np.array([-5.2, -6.0, 3.0])
        pts = np.concatenate([item, sheet, outliers]).astype(np.float32)
        mask = np.ones(len(pts), bool)

        dev = np.asarray(volume.split_item_points(jnp.asarray(pts), jnp.asarray(mask)))
        cpu_dev = jax.devices("cpu")[0]
        with jax.default_device(cpu_dev):
            cpu = np.asarray(
                volume.split_item_points(
                    jax.device_put(pts, cpu_dev), jax.device_put(mask, cpu_dev)
                )
            )
        # The gates sit on medians/MADs, so a handful of borderline flips
        # are legitimate float noise; wholesale divergence is the bug.
        agree = (dev == cpu).mean()
        assert agree > 0.99, f"device/CPU split agreement {agree:.3f}"
        assert dev[:1200].mean() > 0.95  # item kept
        assert dev[1200:1900].mean() < 0.05  # sheet rejected
