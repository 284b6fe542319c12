"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meatmodeler_tpu.geometry import projection, so3
from meatmodeler_tpu.ops import matching
from meatmodeler_tpu.parallel import sharded
from meatmodeler_tpu.solvers import bundle_adjust


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets this)")
    return jax.devices()


def make_ba_problem(seed, n_frames=4, n_points=64, n_obs=256):
    rng = np.random.default_rng(seed)
    k = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], np.float32)
    pts = rng.normal(size=(n_points, 3)).astype(np.float32) * 2
    cams = np.hstack(
        [rng.normal(size=(n_frames, 3)) * 0.1, rng.normal(size=(n_frames, 3))]
    ).astype(np.float32)
    cams[:, 5] += 10
    fidx = rng.integers(0, n_frames, n_obs).astype(np.int32)
    pidx = rng.integers(0, n_points, n_obs).astype(np.int32)
    obs = np.asarray(projection.project_points(pts[pidx], cams[fidx], k)).astype(np.float32)
    obs += rng.normal(scale=0.3, size=obs.shape).astype(np.float32)
    cams0 = cams + rng.normal(scale=0.01, size=cams.shape).astype(np.float32)
    pts0 = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    return bundle_adjust.BAProblem(
        cam_params=jnp.asarray(cams0),
        points=jnp.asarray(pts0),
        intrinsics=jnp.asarray(k),
        obs=jnp.asarray(obs),
        frame_idx=jnp.asarray(fidx),
        point_idx=jnp.asarray(pidx),
        mask=jnp.ones(n_obs, bool),
    )


@pytest.mark.slow
class TestDataParallelBA:
    def test_batched_ba_matches_single(self, devices):
        mesh = sharded.make_mesh(data=8, model=1)
        problems = [make_ba_problem(s) for s in range(8)]
        batched = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
        result = sharded.solve_ba_batch(mesh, batched)
        # Each video's sharded solve must match its local solve.
        for i in [0, 3, 7]:
            local = bundle_adjust.solve_ba(problems[i])
            np.testing.assert_allclose(
                float(result.rmse[i]), float(local.rmse), rtol=1e-4
            )

    def test_config5_scale_class(self, devices):
        """BASELINE config-5 shape class on the virtual mesh: 8 videos
        sharded over 8 cores, each a 16-camera / 1536-point / 6144-obs
        problem (non-toy capacities). Memory banding: the per-video Schur
        strip is P*F*6*3*4 B = 1536*16*72 = 1.7 MB here and 72 MB at the
        full 10k-point/100-camera config-3 scale — both far inside one
        device's memory; problems beyond the band use solve_ba_point_sharded,
        which divides the strip by the mesh size."""
        problems = [
            make_ba_problem(100 + s, n_frames=16, n_points=1536, n_obs=6144)
            for s in range(8)
        ]
        batched = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
        mesh = sharded.make_mesh(data=8, model=1)
        result = sharded.solve_ba_batch(mesh, batched)
        rmse = np.asarray(result.rmse)
        assert np.all(np.isfinite(rmse)) and np.all(rmse < 1.0), rmse
        local = bundle_adjust.solve_ba(problems[5])
        np.testing.assert_allclose(float(result.rmse[5]), float(local.rmse), rtol=1e-4)

    def test_results_improve_cost(self, devices):
        mesh = sharded.make_mesh(data=4, model=2)
        problems = [make_ba_problem(s + 10) for s in range(4)]
        batched = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
        result = sharded.solve_ba_batch(mesh, batched)
        assert np.all(np.asarray(result.rmse) < 1.0)


@pytest.mark.slow
class TestPointShardedBA:
    """ONE BA problem sharded by points over the mesh (SURVEY §5.7)."""

    def test_matches_unsharded_at_10k_points(self, devices):
        # BASELINE config-3 scale class: >= 10k points. Few cameras keep the
        # CPU run quick; the sharded machinery is identical at any F.
        problem = make_ba_problem(42, n_frames=12, n_points=10240, n_obs=40960)
        mesh = sharded.make_mesh(data=8, model=1)
        res_sh = sharded.solve_ba_point_sharded(mesh, problem)
        res = bundle_adjust.solve_ba(problem)
        # Same LM trajectory => same cost/rmse and near-identical parameters.
        np.testing.assert_allclose(float(res_sh.rmse), float(res.rmse), rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(res_sh.cam_params), np.asarray(res.cam_params), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(res_sh.points), np.asarray(res.points), atol=1e-3
        )
        assert int(res_sh.iterations) == int(res.iterations)

    def test_weighted_and_masked(self, devices):
        problem = make_ba_problem(7, n_frames=4, n_points=100, n_obs=512)
        rng = np.random.default_rng(3)
        weight = rng.uniform(0.5, 2.0, 512).astype(np.float32)
        mask = np.asarray(problem.mask).copy()
        mask[::7] = False
        problem = problem._replace(
            weight=jnp.asarray(weight), mask=jnp.asarray(mask)
        )
        mesh = sharded.make_mesh(data=4, model=2)
        res_sh = sharded.solve_ba_point_sharded(mesh, problem)
        res = bundle_adjust.solve_ba(problem)
        np.testing.assert_allclose(float(res_sh.rmse), float(res.rmse), rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(res_sh.points), np.asarray(res.points), atol=1e-3
        )

    def test_adjust_points_opt_in(self, devices):
        from meatmodeler_tpu.config import SolverConfig

        problem = make_ba_problem(11, n_frames=4, n_points=64, n_obs=256)
        ext = projection.extrinsics_from_params(problem.cam_params)
        pts_sh, ext_sh, res_sh = bundle_adjust.adjust_points(
            ext,
            problem.intrinsics,
            problem.points,
            problem.obs,
            problem.frame_idx,
            problem.point_idx,
            config=SolverConfig(point_shard_devices=8),
        )
        pts_1, ext_1, res_1 = bundle_adjust.adjust_points(
            ext,
            problem.intrinsics,
            problem.points,
            problem.obs,
            problem.frame_idx,
            problem.point_idx,
        )
        np.testing.assert_allclose(float(res_sh.rmse), float(res_1.rmse), rtol=1e-4)
        # Shape bucketing pads the sharded problem (64 -> 256 points), which
        # changes the per-shard partitioning and hence float reduction order
        # vs the single-device solve; both LM trajectories stop at ftol=1e-4,
        # so positions agree to solver slop, not bit-exactly.
        np.testing.assert_allclose(np.asarray(pts_sh), np.asarray(pts_1), atol=5e-3)


@pytest.mark.slow
class TestTensorParallelMatching:
    def test_tp_matches_equal_single_device(self, devices):
        rng = np.random.default_rng(0)
        q = rng.integers(0, 2, size=(96, 256)).astype(np.int8)
        t = rng.integers(0, 2, size=(128, 256)).astype(np.int8)
        # Plant strong matches.
        t[32:64] = q[:32]
        qm = np.ones(96, bool)
        tm = np.ones(128, bool)

        mesh = sharded.make_mesh(data=1, model=8)
        idx_tp, d_tp, good_tp = sharded.match_descriptors_tp(
            mesh, jnp.asarray(q), jnp.asarray(t), jnp.asarray(qm), jnp.asarray(tm)
        )

        ref = matching.match_descriptors(
            q, t, qm, tm, cross_check=False, max_matches=96
        )
        # Build reference per-query arrays.
        ref_idx = np.full(96, -1)
        ref_good = np.zeros(96, bool)
        mk = np.asarray(ref.mask)
        ref_idx[np.asarray(ref.query_idx)[mk]] = np.asarray(ref.train_idx)[mk]
        ref_good[np.asarray(ref.query_idx)[mk]] = True

        good_tp = np.asarray(good_tp)
        np.testing.assert_array_equal(good_tp, ref_good)
        np.testing.assert_array_equal(np.asarray(idx_tp)[good_tp], ref_idx[good_tp])


@pytest.mark.slow
class TestShardedPreprocess:
    def test_matches_local(self, devices):
        rng = np.random.default_rng(1)
        frames = rng.integers(0, 255, size=(8, 64, 96, 3), dtype=np.uint8)
        mesh = sharded.make_mesh(data=8, model=1)
        out = sharded.preprocess_sharded(mesh, jnp.asarray(frames))
        from meatmodeler_tpu.ops import clahe

        local = clahe.enhanced_grey(jnp.asarray(frames))
        np.testing.assert_allclose(np.asarray(out), np.asarray(local), atol=1e-3)


class TestSchurStripMemoryBand:
    """solver.hbm_strip_budget_bytes: no silent-OOM path into the dense
    Schur strip (bundle_adjust._solve_normal_equations's
    a = zeros((P, F, 6, 3)))."""

    def test_auto_shards_when_strip_exceeds_budget(self, devices):
        from meatmodeler_tpu.config import SolverConfig

        problem = make_ba_problem(11, n_frames=4, n_points=64, n_obs=256)
        ext = projection.extrinsics_from_params(problem.cam_params)
        args = (
            ext, problem.intrinsics, problem.points, problem.obs,
            problem.frame_idx, problem.point_idx,
        )
        # Bucketed problem: P=256, F=4 -> strip = 2*256*4*18*4 B = 288 KiB.
        # A 100 KiB budget needs ceil(2.88) = 3 point shards (<= 8 devices).
        pts_band, _, res_band = bundle_adjust.adjust_points(
            *args, config=SolverConfig(hbm_strip_budget_bytes=100_000)
        )
        pts_ref, _, res_ref = bundle_adjust.adjust_points(*args)
        np.testing.assert_allclose(
            float(res_band.rmse), float(res_ref.rmse), rtol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(pts_band), np.asarray(pts_ref), atol=5e-3
        )

    def test_auto_shards_arrays_committed_to_one_device(self, devices):
        """Inputs the caller placed on one device (as a previous stage's
        outputs are) still shard over the mesh."""
        from meatmodeler_tpu.config import SolverConfig

        problem = make_ba_problem(13, n_frames=4, n_points=64, n_obs=256)
        ext = projection.extrinsics_from_params(problem.cam_params)
        args = (
            ext, problem.intrinsics, problem.points, problem.obs,
            problem.frame_idx, problem.point_idx,
        )
        placed = [jax.device_put(a, devices[0]) for a in args]
        _, _, res_sh = bundle_adjust.adjust_points(
            *placed, config=SolverConfig(point_shard_devices=4)
        )
        _, _, res_ref = bundle_adjust.adjust_points(*args)
        np.testing.assert_allclose(
            float(res_sh.rmse), float(res_ref.rmse), rtol=1e-4
        )

    def test_refuses_oversized_problem_with_described_error(self, devices):
        """The documented 100k-point x 100-camera band: with a 64 MiB budget
        the strip (~1.4 GiB) needs ~23 shards > 8 devices -> a described
        ValueError BEFORE any allocation, not an OOM inside the solve."""
        from meatmodeler_tpu.config import SolverConfig

        f, p = 100, 100_000
        ext = projection.extrinsics_from_params(jnp.zeros((f, 6), jnp.float32))
        with pytest.raises(ValueError, match="memory band"):
            bundle_adjust.adjust_points(
                ext,
                jnp.eye(3, dtype=jnp.float32),
                jnp.zeros((p, 3), jnp.float32),
                jnp.zeros((8, 2), jnp.float32),
                jnp.zeros(8, jnp.int32),
                jnp.zeros(8, jnp.int32),
                config=SolverConfig(hbm_strip_budget_bytes=64 * 2**20),
            )

    def test_disabled_band_keeps_single_device_path(self, devices):
        from meatmodeler_tpu.config import SolverConfig

        problem = make_ba_problem(12, n_frames=4, n_points=64, n_obs=256)
        ext = projection.extrinsics_from_params(problem.cam_params)
        _, _, res = bundle_adjust.adjust_points(
            ext, problem.intrinsics, problem.points, problem.obs,
            problem.frame_idx, problem.point_idx,
            config=SolverConfig(hbm_strip_budget_bytes=0),
        )
        assert np.isfinite(float(res.rmse))
