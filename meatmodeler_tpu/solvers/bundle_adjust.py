"""Bundle adjustment as Schur-complement Levenberg-Marquardt on the device.

This is the centerpiece rebuild (SURVEY.md §2.4, §7.1): the reference hands a
generic sparse trust-region solver the whole problem
(``scipy.optimize.least_squares(method='trf', jac_sparsity=A)``,
``bundleAdjuster.py:160-194``), encoding the bipartite camera/point structure
only as a sparsity *pattern* (``pointAdjustmentSparsity``,
``bundleAdjuster.py:55-78``). Here that structure is explicit and everything
is dense blocks batched into matmuls:

  * per-observation analytic Jacobians J_c (2x6) and J_p (2x3) via
    ``jax.jacfwd`` of the projection residual, ``vmap``-batched;
  * block-diagonal Hessian pieces U (F,6,6), V (P,3,3) by ``segment_sum``;
  * point-block elimination with batched 3x3 solves;
  * the reduced camera system S (6F x 6F) assembled with one big
    (6F, 3P) x (3P, 6F) matmul — no sparse bookkeeping;
  * dense Cholesky-style solve of S (F ~ 100 -> 600x600: trivial);
  * back-substitution for the point updates;
  * an outer LM damping loop (``lax.while_loop``) with Marquardt diag
    scaling (the role of ``x_scale='jac'``, ``bundleAdjuster.py:184``) and
    the reference's ``ftol=1e-4`` relative-cost stopping rule
    (``bundleAdjuster.py:185``).

Static shapes: observation arrays carry a validity mask so problems of any
size fit a compiled capacity. The whole solve is one XLA program.

Memory banding: the solver's peak term is the dense Schur strip
``a`` (P, F, 6, 3) plus its V^-1 product — ~2 * P * F * 72 bytes
(10k points x 100 cameras -> ~144 MB; 100k x 100 -> ~1.4 GB). Problems
beyond one device's band (``SolverConfig.hbm_strip_budget_bytes``) shard
their points
across the mesh via ``parallel.sharded.solve_ba_point_sharded`` (SURVEY
§5.7), which divides the strip by the mesh size and psum-reduces only the
camera-sized (6F x 6F) system.

Public entry points mirror the reference: ``adjust_points``
(``bundleAdjuster.py:160``) and ``adjust_pose`` (``bundleAdjuster.py:214``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

from meatmodeler_tpu.config import SolverConfig
from meatmodeler_tpu.geometry import projection

__all__ = ["BAProblem", "BAResult", "solve_ba", "adjust_points", "adjust_pose", "pose_only_refine"]


class BAProblem(NamedTuple):
    """Flat observation-list BA problem (static shapes, masked)."""

    cam_params: jax.Array  # (F, 6) [rvec, tvec] per frame
    points: jax.Array  # (P, 3)
    intrinsics: jax.Array  # (3, 3)
    obs: jax.Array  # (N, 2) observed pixels
    frame_idx: jax.Array  # (N,) int32
    point_idx: jax.Array  # (N,) int32
    mask: jax.Array  # (N,) bool — False entries are padding
    # Optional per-observation weights (N,): residuals scale by w, so w is
    # 1/sigma for inverse-variance weighting (ORB-SLAM style: a keypoint
    # detected at pyramid octave o has sigma ~ scale_factor**o px of
    # positional uncertainty and should pull the solution correspondingly
    # less). None = unweighted.
    weight: Optional[jax.Array] = None


class BAResult(NamedTuple):
    cam_params: jax.Array  # (F, 6)
    points: jax.Array  # (P, 3)
    cost: jax.Array  # final 0.5 * sum r^2 over valid obs
    rmse: jax.Array  # reprojection RMSE in pixels over valid obs
    iterations: jax.Array  # LM iterations taken
    # Damping at exit — feed back as ``init_lambda`` to warm-start a related
    # solve (incremental BA re-solving a grown prefix of the same problem).
    final_lambda: jax.Array = 0.0


@matmul_highp
def _residuals(cam_params, points, intrinsics, obs, fidx, pidx, mask, weight=None):
    proj = projection.project_points(points[pidx], cam_params[fidx], intrinsics)
    r = (proj - obs) * mask[:, None]
    if weight is not None:
        r = r * weight[:, None]
    return r


@matmul_highp
def _obs_jacobians(cam_params, points, intrinsics, obs, fidx, pidx, mask, weight=None):
    """Per-observation residual Jacobians: (N,2,6) wrt camera, (N,2,3) wrt point."""

    def one(cam, pt, ob):
        def res(c, p):
            proj = projection.project_points(p[None], c[None], intrinsics)[0]
            return proj - ob

        jc = jax.jacfwd(res, argnums=0)(cam, pt)  # (2, 6)
        jp = jax.jacfwd(res, argnums=1)(cam, pt)  # (2, 3)
        return jc, jp

    jc, jp = jax.vmap(one)(cam_params[fidx], points[pidx], obs)
    m = mask[:, None, None]
    if weight is not None:
        m = m * weight[:, None, None]
    return jc * m, jp * m


def _allsum(x, axis_name):
    """Sum across the point-shard axis (identity when unsharded).

    The SURVEY §5.7 sharded-BA shape: point blocks (V, b_p, delta_p) stay
    local to their core; everything camera-sized (U, b_c, the Schur cross
    term, the reduced RHS, the scalar cost) is psum-reduced — the cross-
    device traffic is O(F^2) camera floats, never O(P) point data.
    """
    return jax.lax.psum(x, axis_name) if axis_name else x


@matmul_highp
def _solve_normal_equations(
    problem: BAProblem, lam: jax.Array, jc, jp, r, axis_name=None,
    fix_points: bool = False,
):
    """One damped Gauss-Newton step via the Schur complement.

    Returns (delta_cam (F,6), delta_pt (P,3)). With ``axis_name``, ``problem``
    holds this core's point shard (local point indices) while cameras are
    replicated; the camera-system reductions are psum'd so every core solves
    the identical reduced system.

    ``fix_points=True`` (the ``adjustPose`` problem): W = V = 0, so the
    Schur complement degenerates to the block-diagonal camera system and
    delta_p = 0 exactly. Taking that branch explicitly skips the per-
    observation point blocks, the (P,3,3) inverses, and the scatter-add
    into the dense (P,F,6,3) strip, none of which XLA can elide from the
    general path (the scatter of W = 0 still executes).
    """
    f = problem.cam_params.shape[0]
    p = problem.points.shape[0]

    # Block-diagonal Hessian pieces.
    u = _allsum(
        jax.ops.segment_sum(
            jnp.einsum("nri,nrj->nij", jc, jc), problem.frame_idx, num_segments=f
        ),
        axis_name,
    )  # (F, 6, 6)
    if fix_points:
        b_c = -_allsum(
            jax.ops.segment_sum(
                jnp.einsum("nri,nr->ni", jc, r), problem.frame_idx, num_segments=f
            ),
            axis_name,
        )  # (F, 6)
        eye6 = jnp.eye(6, dtype=u.dtype)
        u_d = u + lam * (u * eye6 + 1e-8 * eye6)
        u_trace = jnp.einsum("fii->f", u)
        u_d = jnp.where((u_trace < 1e-12)[:, None, None], eye6, u_d)
        delta_c = jnp.linalg.solve(u_d, b_c[..., None])[..., 0]
        return delta_c, jnp.zeros_like(problem.points)
    v = jax.ops.segment_sum(
        jnp.einsum("nri,nrj->nij", jp, jp), problem.point_idx, num_segments=p
    )  # (P, 3, 3) — local to this core's point shard
    w = jnp.einsum("nri,nrj->nij", jc, jp)  # (N, 6, 3) — one block per obs

    b_c = -_allsum(
        jax.ops.segment_sum(
            jnp.einsum("nri,nr->ni", jc, r), problem.frame_idx, num_segments=f
        ),
        axis_name,
    )  # (F, 6)
    b_p = -jax.ops.segment_sum(
        jnp.einsum("nri,nr->ni", jp, r), problem.point_idx, num_segments=p
    )  # (P, 3)

    # Marquardt damping on the block diagonals (scale-invariant, the role the
    # reference delegates to x_scale='jac').
    eye6 = jnp.eye(6, dtype=u.dtype)
    eye3 = jnp.eye(3, dtype=v.dtype)
    u_d = u + lam * (u * eye6 + 1e-8 * eye6)
    v_d = v + lam * (v * eye3 + 1e-8 * eye3)

    # Guard padded/unobserved points: their V block is ~0; make it identity so
    # the inverse is benign (their delta comes out ~0 since b_p is 0 there).
    # Degeneracy is tested on the UNDAMPED trace: multiplicative damping gives
    # a padded block trace of k*lam*1e-8 (~1e-11 at default lam), which would
    # slip past the threshold and leave a near-singular block in the system.
    v_trace = v[:, 0, 0] + v[:, 1, 1] + v[:, 2, 2]
    degenerate = (v_trace < 1e-12)[:, None, None]
    v_d = jnp.where(degenerate, eye3, v_d)

    # Same guard for padded/unobserved CAMERAS (shape-bucketed problems pad
    # the frame axis): an all-masked camera has U = 0 and W = 0, so with an
    # identity U block its rows of S decouple exactly and its delta solves
    # to 0 (rhs is 0 there) — real parameters are untouched.
    u_trace = jnp.einsum("fii->f", u)
    degenerate_u = (u_trace < 1e-12)[:, None, None]
    u_d = jnp.where(degenerate_u, eye6, u_d)

    v_inv = jnp.linalg.inv(v_d)  # (P, 3, 3) batched closed-form inverse

    # Scatter W blocks into the dense per-point camera strip A_p (P, F*6, 3):
    # row block f of A_p is W_{f,p}. Then
    #   S = U_blkdiag - sum_p A_p V_p^{-1} A_p^T
    # assembles with one big matmul pair.
    a = jnp.zeros((p, f, 6, 3), dtype=w.dtype)
    a = a.at[problem.point_idx, problem.frame_idx].add(w)
    a_flat = a.reshape(p, f * 6, 3)
    b_strip = jnp.einsum("pak,pkl->pal", a_flat, v_inv)  # (P, 6F, 3)
    s_cross = _allsum(jnp.einsum("pak,pbk->ab", b_strip, a_flat), axis_name)  # (6F, 6F)

    # Block-diagonal U embedded densely without a Python loop:
    s = -s_cross
    fi = jnp.arange(f)
    s = s.reshape(f, 6, f, 6).at[fi, :, fi, :].add(u_d).reshape(f * 6, f * 6)

    # Reduced RHS: b~_c = b_c - sum_n Y_n b_p[p_n].
    y = jnp.einsum("nij,njk->nik", w, v_inv[problem.point_idx])  # (N, 6, 3)
    red = _allsum(
        jax.ops.segment_sum(
            jnp.einsum("nij,nj->ni", y, b_p[problem.point_idx]),
            problem.frame_idx,
            num_segments=f,
        ),
        axis_name,
    )
    rhs = (b_c - red).reshape(f * 6)

    delta_c = jnp.linalg.solve(s, rhs).reshape(f, 6)

    # Back-substitute: delta_p = V^-1 (b_p - sum_{n in p} W_n^T delta_c[f_n]).
    wt_dc = jax.ops.segment_sum(
        jnp.einsum("nij,ni->nj", w, delta_c[problem.frame_idx]),
        problem.point_idx,
        num_segments=p,
    )
    delta_p = jnp.einsum("pij,pj->pi", v_inv, b_p - wt_dc)
    return delta_c, delta_p


@matmul_highp
def _cost(problem, cam, pts, axis_name=None):
    r = _residuals(
        cam, pts, problem.intrinsics, problem.obs,
        problem.frame_idx, problem.point_idx, problem.mask, problem.weight,
    )
    return _allsum(0.5 * jnp.sum(r * r), axis_name)


@partial(jax.jit, static_argnames=("config", "fix_points", "axis_name"))
@matmul_highp
def solve_ba(
    problem: BAProblem,
    config: SolverConfig = SolverConfig(),
    fix_points: bool = False,
    axis_name: Optional[str] = None,
    init_lambda: Optional[jax.Array] = None,
) -> BAResult:
    """Run Schur-complement LM until ftol convergence or max_iters.

    Args:
      problem: the masked flat BA problem.
      config: damping schedule + stopping criteria (defaults mirror the
        reference's ftol=1e-4).
      fix_points: if True, only camera parameters move (the ``adjustPose``
        problem, ``bundleAdjuster.py:206-243``).
      axis_name: when set, the call runs inside a ``shard_map`` whose
        ``axis_name`` axis shards the POINTS of one big problem
        (``problem.points``/observations are this core's shard with local
        point indices; cameras replicated). Camera-system reductions are
        psum'd so every core walks the identical LM trajectory (SURVEY §5.7;
        use ``parallel.sharded.solve_ba_point_sharded`` to set this up).
      init_lambda: optional RUNTIME damping override (a traced scalar, so no
        recompile per value — unlike ``config.init_lambda``, which is static).
        Warm-starting a grown prefix of the same problem from the previous
        solve's ``final_lambda`` skips the damping walk-down the reference's
        intended online design would repeat per keyframe
        (``processor.py:395-408``).

    Returns:
      BAResult with refined parameters and convergence stats (with
      ``axis_name``: cam/cost/rmse replicated, points local to the shard).
    """

    # Canonicalize float dtypes: mixed f32/f64 inputs (e.g. f32 detections
    # with f64 oracle intrinsics) would otherwise change dtypes across the
    # while_loop carry.
    dtype = jnp.promote_types(
        jnp.promote_types(problem.cam_params.dtype, problem.points.dtype),
        jnp.promote_types(problem.obs.dtype, problem.intrinsics.dtype),
    )
    problem = problem._replace(
        cam_params=problem.cam_params.astype(dtype),
        points=problem.points.astype(dtype),
        intrinsics=problem.intrinsics.astype(dtype),
        obs=problem.obs.astype(dtype),
        weight=None if problem.weight is None else problem.weight.astype(dtype),
    )

    n_valid = jnp.maximum(_allsum(jnp.sum(problem.mask), axis_name), 1)

    def body(state):
        cam, pts, lam, cost, it, _ = state
        r = _residuals(
            cam, pts, problem.intrinsics, problem.obs,
            problem.frame_idx, problem.point_idx, problem.mask, problem.weight,
        )
        jc, jp = _obs_jacobians(
            cam, pts, problem.intrinsics, problem.obs,
            problem.frame_idx, problem.point_idx, problem.mask, problem.weight,
        )
        def attempt(lam_try):
            # fix_points short-circuits inside: delta_p = 0 exactly and the
            # whole point side of the Schur machinery is skipped (jp is
            # dead-code-eliminated by XLA along with it).
            dc, dp = _solve_normal_equations(
                problem._replace(cam_params=cam, points=pts), lam_try, jc, jp, r,
                axis_name=axis_name, fix_points=fix_points,
            )
            new_cam = cam + dc
            new_pts = pts + dp
            return new_cam, new_pts, _cost(problem, new_cam, new_pts, axis_name)

        c1_cam, c1_pts, c1 = attempt(lam)
        c2_cam, c2_pts, c2 = attempt(lam * config.lambda_up * config.lambda_up)
        use1 = c1 <= c2
        cand_cam = jnp.where(use1, c1_cam, c2_cam)
        cand_pts = jnp.where(use1, c1_pts, c2_pts)
        cand_cost = jnp.where(use1, c1, c2)
        cand_lam = jnp.where(
            use1, lam * config.lambda_down, lam * config.lambda_up * config.lambda_up
        )

        improved = cand_cost < cost
        new_cam = jnp.where(improved, cand_cam, cam)
        new_pts = jnp.where(improved, cand_pts, pts)
        new_cost = jnp.where(improved, cand_cost, cost)
        new_lam = jnp.where(improved, cand_lam, lam * config.lambda_up**2)
        new_lam = jnp.clip(new_lam, 1e-12, 1e12)

        # Reference stopping rule: relative cost decrease below ftol
        # (scipy TRF: dF < ftol * F).
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-30)
        done = improved & (rel < config.ftol)
        # Also stop when damping has exploded (no progress possible).
        done = done | (~improved & (lam >= 1e10))
        return new_cam, new_pts, new_lam, new_cost, it + 1, done

    def cond(state):
        _, _, _, _, it, done = state
        return (it < config.max_iters) & (~done)

    cost0 = _cost(problem, problem.cam_params, problem.points, axis_name)
    lam0 = (
        jnp.array(config.init_lambda, problem.cam_params.dtype)
        if init_lambda is None
        else jnp.asarray(init_lambda, problem.cam_params.dtype)
    )
    init = (
        problem.cam_params,
        problem.points,
        lam0,
        cost0,
        jnp.array(0, jnp.int32),
        jnp.array(False),
    )
    cam, pts, lam_out, cost, iters, _ = jax.lax.while_loop(cond, body, init)
    # Report the UNWEIGHTED pixel RMSE regardless of observation weighting
    # (the comparable metric across weighted and unweighted solves).
    r_px = _residuals(
        cam, pts, problem.intrinsics, problem.obs,
        problem.frame_idx, problem.point_idx, problem.mask,
    )
    rmse = jnp.sqrt(_allsum(jnp.sum(r_px * r_px), axis_name) / n_valid)
    return BAResult(cam, pts, cost, rmse, iters, lam_out)


# --------------------------------------------------------------------------
# Reference-mirroring entry points
# --------------------------------------------------------------------------


def adjust_points(
    extrinsics,
    intrinsics,
    points_3d,
    points_2d,
    frame_indices,
    point_indices,
    mask: Optional[jax.Array] = None,
    weights: Optional[jax.Array] = None,
    config: SolverConfig = SolverConfig(),
    init_lambda: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, BAResult]:
    """Full bundle adjustment over cameras and points.

    Mirror of ``bundleAdjuster.adjustPoints`` (``bundleAdjuster.py:160-194``):
    same inputs (extrinsics may be (F,3,4) or (F,4,4); ``points_3d`` may carry
    the reference's (P,1,3) shape from ``managePoints``, ``processor.py:261``)
    and same outputs — refined (P,3) points plus (F,4,4) homogeneous
    extrinsics as ``reformatPointResult`` returns (``bundleAdjuster.py:153``)
    — with the solver stats appended.

    ``init_lambda``: optional runtime damping warm-start (see ``solve_ba``).
    """
    extrinsics = jnp.asarray(extrinsics)
    points_3d = jnp.asarray(points_3d).reshape(-1, 3)
    points_2d = jnp.asarray(points_2d).reshape(-1, 2)
    frame_indices = jnp.asarray(frame_indices, jnp.int32)
    point_indices = jnp.asarray(point_indices, jnp.int32)
    weights = None if weights is None else jnp.asarray(weights)

    n_f, n_p = extrinsics.shape[0], points_3d.shape[0]
    # The shard decision below is pure host shape/config arithmetic on the
    # PADDED problem sizes — computed without materializing the padded
    # arrays so the unsharded path can run as one jitted program.
    pb = _ceil_to(n_p, config.bucket[1])
    fb = _ceil_to(n_f, config.bucket[0])
    shards = max(config.point_shard_devices, 1)
    if config.hbm_strip_budget_bytes > 0:
        # The no-silent-OOM band: the dense Schur strip a (P, F, 6, 3) plus
        # its V^-1 product peak at ~2 * P_local * F * 72 bytes of f32. If the
        # requested sharding (or the single device) cannot hold it, shard the
        # points over enough devices that each holds a strip inside the
        # budget — or refuse with the numbers spelled out.
        itemsize = jnp.promote_types(points_3d.dtype, jnp.float32).itemsize
        strip_bytes = 2 * pb * fb * 18 * itemsize
        need = -(-strip_bytes // config.hbm_strip_budget_bytes)  # ceil
        if need > shards:
            avail = len(jax.devices())
            if need > avail:
                raise ValueError(
                    f"BA problem too large for the configured memory band: "
                    f"the dense Schur strip over {pb} points x {fb} cameras "
                    f"is ~{strip_bytes / 2**20:.1f} MiB, needing {need} "
                    f"point shards at hbm_strip_budget_bytes="
                    f"{config.hbm_strip_budget_bytes / 2**20:.1f} MiB/device, "
                    f"but only {avail} devices are addressable. Run on a "
                    f"larger slice, raise solver.hbm_strip_budget_bytes, or "
                    f"reduce the problem (fewer tracks/keyframes)."
                )
            shards = int(need)
    if shards > 1:
        # Sharded single-problem solve (SURVEY §5.7) — opt-in via
        # point_shard_devices or auto-selected by the band above; lazy import
        # to avoid a module cycle (parallel.sharded imports this module).
        from meatmodeler_tpu.parallel import sharded

        if mask is None:
            mask = jnp.ones(points_2d.shape[0], bool)
        problem = _pad_problem(
            BAProblem(
                cam_params=projection.params_from_extrinsics(extrinsics),
                points=points_3d,
                intrinsics=jnp.asarray(intrinsics),
                obs=points_2d,
                frame_idx=frame_indices,
                point_idx=point_indices,
                mask=mask,
                weight=weights,
            ),
            config.bucket,
        )
        n = min(shards, len(jax.devices()))
        mesh = sharded.make_mesh(data=n, model=1)
        result = sharded.solve_ba_point_sharded(
            mesh, problem, config=config, init_lambda=init_lambda
        )
        result = result._replace(
            cam_params=result.cam_params[:n_f], points=result.points[:n_p]
        )
        new_ext = projection.extrinsics_from_params(
            result.cam_params, homogeneous=True
        )
        return result.points, new_ext, result
    # Single-device path: SO(3) packing, padding, solve, and unpacking fused
    # into one program — dispatched op-by-op, the glue alone was ~15 tiny
    # programs, each its own cold compile (see _adjust_pose_jit).
    return _adjust_points_jit(
        extrinsics,
        jnp.asarray(intrinsics),
        points_3d,
        points_2d,
        frame_indices,
        point_indices,
        mask,
        weights,
        init_lambda,
        config=config,
    )


@partial(jax.jit, static_argnames=("config",))
@matmul_highp
def _adjust_points_jit(
    extrinsics,
    intrinsics,
    points_3d,
    points_2d,
    frame_indices,
    point_indices,
    mask,
    weights,
    init_lambda,
    config: SolverConfig,
) -> Tuple[jax.Array, jax.Array, BAResult]:
    if mask is None:
        mask = jnp.ones(points_2d.shape[0], bool)
    n_f, n_p = extrinsics.shape[0], points_3d.shape[0]
    problem = BAProblem(
        cam_params=projection.params_from_extrinsics(extrinsics),
        points=points_3d,
        intrinsics=intrinsics,
        obs=points_2d,
        frame_idx=frame_indices,
        point_idx=point_indices,
        mask=mask,
        weight=weights,
    )
    # Shape-bucketed solve: problem sizes are data-dependent, so padding to
    # bucket multiples lets different videos reuse one ~20 s compile.
    problem = _pad_problem(problem, config.bucket)
    result = solve_ba(problem, config=config, init_lambda=init_lambda)
    result = result._replace(
        cam_params=result.cam_params[:n_f], points=result.points[:n_p]
    )
    new_ext = projection.extrinsics_from_params(result.cam_params, homogeneous=True)
    return result.points, new_ext, result


def _ceil_to(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q if q > 1 else n


def _pad_problem(problem: BAProblem, bucket: Tuple[int, int, int]) -> BAProblem:
    """Pad (frames, points, observations) up to bucket multiples.

    Padded observations carry mask=False (index 0 is fine — masked Jacobians
    and residuals are zeroed before every reduction); padded points and
    cameras end up fully unobserved, which the degenerate-U/V guards in
    ``_solve_normal_equations`` turn into decoupled identity blocks, so the
    solve over real parameters is bit-for-bit the unpadded trajectory (up to
    LU rounding in the larger-but-block-diagonal reduced system).
    """
    fq, pq, nq = bucket
    f, p, n = problem.cam_params.shape[0], problem.points.shape[0], problem.obs.shape[0]
    fb, pb, nb = _ceil_to(f, fq), _ceil_to(p, pq), _ceil_to(n, nq)
    if (fb, pb, nb) == (f, p, n):
        return problem

    def pad0(x, total, axis=0):
        width = [(0, 0)] * x.ndim
        width[axis] = (0, total - x.shape[axis])
        return jnp.pad(x, width)

    return problem._replace(
        cam_params=pad0(problem.cam_params, fb),
        points=pad0(problem.points, pb),
        obs=pad0(problem.obs, nb),
        frame_idx=pad0(problem.frame_idx, nb),
        point_idx=pad0(problem.point_idx, nb),
        mask=pad0(problem.mask, nb),
        weight=None if problem.weight is None else pad0(problem.weight, nb),
    )


def _chessboard_xz(pattern: Tuple[int, int], side_length: float, dtype):
    """The reference's pose-BA board: X-Z plane, y = 0
    (``bundleAdjuster.py:220-223`` duplicating ``processor.py:162-166``).
    """
    x, y = pattern
    xs = jnp.arange(x, dtype=dtype) * side_length
    ys = jnp.arange(y, dtype=dtype) * side_length
    gx, gy = jnp.meshgrid(xs, ys)
    pts = jnp.zeros((x * y, 3), dtype)
    pts = pts.at[:, 0].set(gx.reshape(-1))
    pts = pts.at[:, 2].set(gy.reshape(-1))
    return pts


def adjust_pose(
    extrinsics,
    intrinsics,
    points_2d,
    pattern: Tuple[int, int] = (4, 3),
    side_length: float = 2.0,
    config: SolverConfig = SolverConfig(),
) -> Tuple[jax.Array, BAResult]:
    """Pose-only bundle adjustment against the known chessboard.

    Mirror of ``bundleAdjuster.adjustPose`` (``bundleAdjuster.py:214-243``):
    ``points_2d`` is F stacked copies of the detected board corners; the 3D
    board is rebuilt internally (the reference hard-codes (4,3)/side 2 — here
    they are defaulted, not hard-coded). Returns (F,3,4) extrinsics like
    ``reformatPoseResult`` (``bundleAdjuster.py:197-203``).

    With points fixed, frames decouple: this is F independent 6-dof solves,
    which the Schur solver handles naturally (W = 0).

    The whole body (SO(3) packing, board/index construction, padded solve,
    unpacking) is one jitted program: traced op-by-op it dispatched ~40 tiny
    programs, each its own cold compile, and that glue, not the solver, was
    most of the cold pose-BA stage.
    """
    return _adjust_pose_jit(
        jnp.asarray(extrinsics),
        jnp.asarray(intrinsics),
        jnp.asarray(points_2d).reshape(-1, 2),
        pattern=pattern,
        side_length=side_length,
        config=config,
    )


@partial(jax.jit, static_argnames=("pattern", "side_length", "config"))
@matmul_highp
def _adjust_pose_jit(
    extrinsics,
    intrinsics,
    points_2d,
    pattern: Tuple[int, int],
    side_length: float,
    config: SolverConfig,
) -> Tuple[jax.Array, BAResult]:
    f = extrinsics.shape[0]
    n = points_2d.shape[0] // f

    board = _chessboard_xz(pattern, side_length, points_2d.dtype)[:n]
    frame_idx = jnp.repeat(jnp.arange(f, dtype=jnp.int32), n)
    point_idx = jnp.tile(jnp.arange(n, dtype=jnp.int32), f)

    problem = BAProblem(
        cam_params=projection.params_from_extrinsics(extrinsics),
        points=board,
        intrinsics=intrinsics,
        obs=points_2d,
        frame_idx=frame_idx,
        point_idx=point_idx,
        mask=jnp.ones(points_2d.shape[0], bool),
    )
    # Bucket only the frame/obs axes (the point axis is the fixed board):
    # pose-BA problem shapes vary with the keyframe count per video.
    result = solve_ba(
        _pad_problem(problem, (config.bucket[0], 1, config.bucket[0] * n)),
        config=config,
        fix_points=True,
    )
    result = result._replace(cam_params=result.cam_params[:f])
    return projection.extrinsics_from_params(result.cam_params), result


@matmul_highp
def pose_only_refine(
    cam_params: jax.Array,
    points_3d: jax.Array,
    intrinsics: jax.Array,
    obs: jax.Array,
    mask: jax.Array,
    config: SolverConfig = SolverConfig(),
) -> jax.Array:
    """Vmapped independent per-frame pose refinement against fixed points.

    The fully-decoupled fast path for pose-only problems: (F,) independent
    6-dof LM solves in one program. ``points_3d``/``obs``/``mask`` are
    (F, N, ...) per-frame arrays.
    """

    def one(cam, pts, ob, mk):
        problem = BAProblem(
            cam_params=cam[None],
            points=pts,
            intrinsics=intrinsics,
            obs=ob,
            frame_idx=jnp.zeros(ob.shape[0], jnp.int32),
            point_idx=jnp.arange(ob.shape[0], dtype=jnp.int32),
            mask=mk,
        )
        return solve_ba(problem, config=config, fix_points=True).cam_params[0]

    return jax.vmap(one)(cam_params, points_3d, obs, mask)
