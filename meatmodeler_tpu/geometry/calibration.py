"""Camera calibration from planar chessboard views (Zhang's method + LM).

Replacement for ``cv2.calibrateCamera`` (``processor.py:49-53``):

  1. per-view DLT homographies board-plane -> image (``vmap``),
  2. closed-form intrinsics from the absolute-conic constraints (Zhang 2000),
  3. per-view extrinsic initialization from H and K,
  4. joint Levenberg-Marquardt over [fx, fy, cx, cy, k1, k2, p1, p2, k3] and
     all 6F poses, minimizing distorted-reprojection error — the same
     functional OpenCV's internal LM minimizes, so results are held to
     statistical (RMSE) parity (SURVEY.md §7.3.4).

The whole solve is one jitted XLA program; the per-view work is batched.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

from meatmodeler_tpu.geometry import distortion as distortion_mod
from meatmodeler_tpu.geometry import projection, so3
from meatmodeler_tpu.geometry.homography import find_homography

__all__ = ["chessboard_object_points", "calibrate", "CalibrationResult"]


class CalibrationResult(NamedTuple):
    intrinsics: jax.Array  # (3, 3)
    dist: jax.Array  # (5,) [k1, k2, p1, p2, k3]
    poses: jax.Array  # (F, 6) per-view [rvec, tvec]
    rms: jax.Array  # scalar reprojection RMS in pixels


def chessboard_object_points(pattern: Tuple[int, int], dtype=jnp.float32) -> jax.Array:
    """Planar (z=0) chessboard grid, matching ``calibrate``'s object points
    (``processor.py:40-42``): column-major over x then y, unit squares.
    """
    x, y = pattern
    xs = jnp.arange(x, dtype=dtype)
    ys = jnp.arange(y, dtype=dtype)
    gx, gy = jnp.meshgrid(xs, ys)  # gy-major like np.mgrid[0:x,0:y].T
    grid = jnp.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    return jnp.concatenate([grid, jnp.zeros((x * y, 1), dtype)], axis=-1)


@matmul_highp
def _intrinsics_from_homographies(homs: jax.Array, view_mask=None) -> jax.Array:
    """Closed-form K from >= 3 plane homographies (Zhang's B-matrix solve).

    ``view_mask``: optional (F,) bool — masked views' constraint rows are
    zeroed (padded views in a shape-bucketed solve contribute nothing).
    """

    def v_ij(h, i, j):
        return jnp.stack(
            [
                h[0, i] * h[0, j],
                h[0, i] * h[1, j] + h[1, i] * h[0, j],
                h[1, i] * h[1, j],
                h[2, i] * h[0, j] + h[0, i] * h[2, j],
                h[2, i] * h[1, j] + h[1, i] * h[2, j],
                h[2, i] * h[2, j],
            ]
        )

    def rows(h):
        return jnp.stack([v_ij(h, 0, 1), v_ij(h, 0, 0) - v_ij(h, 1, 1)])

    v = jax.vmap(rows)(homs)
    if view_mask is not None:
        v = v * view_mask.astype(v.dtype)[:, None, None]
    v = v.reshape(-1, 6)
    _, vecs = jnp.linalg.eigh(v.T @ v)
    b = vecs[:, 0]
    b11, b12, b22, b13, b23, b33 = b[0], b[1], b[2], b[3], b[4], b[5]

    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = jnp.sqrt(jnp.abs(lam / b11))
    fy = jnp.sqrt(jnp.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam

    return jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


@matmul_highp
def _pose_from_homography(h: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """Extrinsic init from a z=0-plane homography: H = s K [r1 r2 t]."""
    m = jnp.linalg.solve(intrinsics, h)
    scale = 0.5 * (jnp.linalg.norm(m[:, 0]) + jnp.linalg.norm(m[:, 1]))
    m = m / jnp.maximum(scale, 1e-12)
    m = m * jnp.where(m[2, 2] < 0, -1.0, 1.0)
    r1, r2, tvec = m[:, 0], m[:, 1], m[:, 2]
    rot = jnp.stack([r1, r2, jnp.cross(r1, r2)], axis=1)
    u, _, vt = jnp.linalg.svd(rot)
    d = jnp.linalg.det(u @ vt)
    rot = u @ jnp.diag(jnp.array([1.0, 1.0, d])) @ vt
    return jnp.concatenate([so3.log(rot), tvec])


def _project_distorted(obj_pts, pose, intrinsics, dist):
    """Project with distortion applied in normalized coordinates."""
    cam = projection.rotate_points(obj_pts, pose[None, :3]) + pose[None, 3:6]
    xy = cam[..., :2] / cam[..., 2:3]
    xyd = distortion_mod.distort_normalized(xy, dist)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    return xyd * jnp.stack([fx, fy]) + jnp.stack([cx, cy])


@matmul_highp
def _single_focal_init(homs: jax.Array, cx, cy, view_mask=None) -> jax.Array:
    """Closed-form focal with a known principal point and zero skew.

    With K = [[f,0,cx],[0,f,cy],[0,0,1]], B = K^-T K^-1 = x*C + E where
    x = 1/f^2, C = [[1,0,-cx],[0,1,-cy],[-cx,-cy,cx^2+cy^2]] and E = e3 e3^T.
    Every Zhang constraint v^T b = 0 becomes a_i x + b_i = 0, solved in least
    squares — robust where the full 6-dof B solve is degenerate (small board,
    turntable orbits: the reference's own scenario).
    """
    c_mat = jnp.array(
        [[1.0, 0.0, -cx], [0.0, 1.0, -cy], [-cx, -cy, cx * cx + cy * cy]]
    )
    e_mat = jnp.zeros((3, 3)).at[2, 2].set(1.0)

    def constraints(h):
        h1, h2 = h[:, 0], h[:, 1]
        # v12 . b = 0  and  (v11 - v22) . b = 0 expressed via B directly.
        a1 = h1 @ c_mat @ h2
        b1 = h1 @ e_mat @ h2
        a2 = h1 @ c_mat @ h1 - h2 @ c_mat @ h2
        b2 = h1 @ e_mat @ h1 - h2 @ e_mat @ h2
        return jnp.array([a1, a2]), jnp.array([b1, b2])

    a, b = jax.vmap(constraints)(homs)
    if view_mask is not None:
        vm = view_mask.astype(a.dtype)[:, None]
        a = a * vm
        b = b * vm
    a = a.reshape(-1)
    b = b.reshape(-1)
    x = -jnp.sum(a * b) / jnp.maximum(jnp.sum(a * a), 1e-12)
    return 1.0 / jnp.sqrt(jnp.clip(x, 1e-12, 1e2))


@partial(
    jax.jit,
    static_argnames=("num_dist", "max_iters", "fix_principal_point", "single_focal"),
)
@matmul_highp
def calibrate(
    img_points: jax.Array,
    obj_points: jax.Array,
    image_size: jax.Array,
    num_dist: int = 5,
    max_iters: int = 30,
    fix_principal_point: bool = False,
    single_focal: bool = False,
    view_mask=None,
) -> CalibrationResult:
    """Calibrate from F planar views.

    Args:
      img_points: (F, N, 2) detected corner pixels per view
        (``frame_corners`` at ``processor.py:422``).
      obj_points: (N, 3) planar target points with z = 0
        (``chessboard_object_points``).
      image_size: (2,) [width, height] — principal-point prior / fixed value.
      num_dist: how many leading distortion coefficients to estimate
        (OpenCV default estimates all 5; 0 disables distortion).
      max_iters: LM iterations.
      fix_principal_point: pin (cx, cy) to the image center — essential when
        the target covers a small image fraction (the reference's (4, 3)
        board makes full calibration degenerate; cv2 fails on it too).
      single_focal: estimate one f for both axes (CALIB_FIX_ASPECT_RATIO).
      view_mask: optional (F,) bool — False rows are PADDING (shape-bucketed
        callers pad ``img_points`` with copies of a real view so every
        intermediate stays finite); their Zhang constraints and residuals
        are zeroed, so they contribute nothing to K/dist/rms, and their
        pose slots converge to the copied view's init with zero gradient.

    Returns:
      CalibrationResult(K, dist5, per-view poses, reprojection RMS).
    """
    f, n = img_points.shape[0], img_points.shape[1]
    plane = obj_points[:, :2]
    w, h = image_size[0], image_size[1]

    homs = jax.vmap(lambda img: find_homography(plane, img))(img_points)

    if fix_principal_point or single_focal:
        cx0, cy0 = 0.5 * w, 0.5 * h
        f0 = _single_focal_init(homs, cx0, cy0, view_mask)
        f0 = jnp.where(jnp.isfinite(f0), f0, 1.2 * w)
        k_init = jnp.array([[f0, 0.0, cx0], [0.0, f0, cy0], [0.0, 0.0, 1.0]])
    else:
        k_init = _intrinsics_from_homographies(homs, view_mask)
        # Degenerate-geometry fallback: principal point at image center,
        # focal from a sane FOV guess.
        bad = ~jnp.all(jnp.isfinite(k_init))
        k_fallback = jnp.array(
            [[1.2 * w, 0.0, 0.5 * w], [0.0, 1.2 * w, 0.5 * h], [0.0, 0.0, 1.0]],
            dtype=img_points.dtype,
        )
        k_init = jnp.where(bad, k_fallback, k_init)

    poses0 = jax.vmap(lambda hh: _pose_from_homography(hh, k_init))(homs)

    # --- joint LM over [intrinsic dof, dist(num_dist), poses(6F)] ---
    n_focal = 1 if single_focal else 2
    n_pp = 0 if fix_principal_point else 2
    n_intr = n_focal + n_pp + num_dist

    def unpack(theta):
        fx = theta[0]
        fy = theta[0] if single_focal else theta[1]
        if fix_principal_point:
            cx, cy = 0.5 * w, 0.5 * h
        else:
            cx, cy = theta[n_focal], theta[n_focal + 1]
        intr = jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        dist = jnp.zeros(5, theta.dtype).at[:num_dist].set(
            theta[n_focal + n_pp : n_intr]
        )
        poses = theta[n_intr:].reshape(f, 6)
        return intr, dist, poses

    def residual(theta):
        intr, dist, poses = unpack(theta)
        proj = jax.vmap(lambda p: _project_distorted(obj_points, p, intr, dist))(poses)
        r = proj - img_points
        if view_mask is not None:
            r = r * view_mask.astype(r.dtype)[:, None, None]
        return r.reshape(-1)

    intr0 = [k_init[0, 0]] if single_focal else [k_init[0, 0], k_init[1, 1]]
    if not fix_principal_point:
        intr0 += [k_init[0, 2], k_init[1, 2]]
    theta0 = jnp.concatenate(
        [
            jnp.array(intr0),
            jnp.zeros(num_dist, img_points.dtype),
            poses0.reshape(-1),
        ]
    )

    n_params = theta0.shape[0]

    def lm_step(state):
        theta, lam, cost, it, _ = state
        r = residual(theta)
        jac = jax.jacfwd(residual)(theta)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        diag = jnp.diag(jnp.maximum(jnp.diag(jtj), 1e-12))

        def try_lambda(lam_try):
            step = jnp.linalg.solve(jtj + lam_try * diag, jtr)
            new_theta = theta - step
            new_cost = 0.5 * jnp.sum(residual(new_theta) ** 2)
            return new_theta, new_cost

        t1, c1 = try_lambda(lam)
        t2, c2 = try_lambda(lam * 10.0)
        use1 = c1 <= c2
        cand_theta = jnp.where(use1, t1, t2)
        cand_cost = jnp.where(use1, c1, c2)
        cand_lam = jnp.where(use1, lam * 0.5, lam * 10.0)

        improved = cand_cost < cost
        new_theta = jnp.where(improved, cand_theta, theta)
        new_cost = jnp.where(improved, cand_cost, cost)
        new_lam = jnp.where(improved, cand_lam, lam * 10.0)
        rel = jnp.abs(cost - new_cost) / jnp.maximum(cost, 1e-12)
        done = (~improved & (lam > 1e8)) | (rel < 1e-10)
        return new_theta, new_lam, new_cost, it + 1, done

    def cond(state):
        _, _, _, it, done = state
        return (it < max_iters) & (~done)

    def run_lm(t0):
        cost0 = 0.5 * jnp.sum(residual(t0) ** 2)
        t_fin, _, cost_fin, _, _ = jax.lax.while_loop(
            cond, lm_step, (t0, jnp.array(1e-3, t0.dtype), cost0, 0, False)
        )
        return t_fin, cost_fin

    theta, cost = run_lm(theta0)

    # Second pass: rescue OUTLIER frames only. A view whose homography pose
    # init landed in the wrong basin of the planar two-fold ambiguity stays
    # stuck (its 2N residuals are a small share of the joint cost), drags the
    # focal away, and poisons the whole calibration. Re-initializing only the
    # high-error frames with two-candidate planar PnP under the current
    # intrinsics (good frames keep their converged poses) puts every frame in
    # the right basin for the re-run.
    from meatmodeler_tpu.geometry import pnp

    intr1, dist1, poses1 = unpack(theta)
    und = distortion_mod.undistort_pixels(img_points, intr1, dist1)
    res1 = residual(theta).reshape(f, n, 2)
    frame_err = jnp.sqrt(jnp.sum(res1**2, axis=-1)).mean(axis=1)  # (F,)
    if view_mask is None:
        med_err = jnp.median(frame_err)
        bad_frame = frame_err > 3.0 * med_err + 0.5
    else:
        # Median over REAL views only; padded views are never "rescued".
        med_err = jnp.nanmedian(jnp.where(view_mask, frame_err, jnp.nan))
        bad_frame = view_mask & (frame_err > 3.0 * med_err + 0.5)
    poses_pnp = pnp.solve_pnp_batch(plane, (0, 1), obj_points, und, intr1)
    poses_mix = jnp.where(bad_frame[:, None], poses_pnp, poses1)
    theta2, cost2 = run_lm(
        jnp.concatenate([theta[:n_intr], poses_mix.reshape(-1)])
    )
    better = cost2 < cost
    theta = jnp.where(better, theta2, theta)
    cost = jnp.where(better, cost2, cost)

    intr, dist, poses = unpack(theta)
    n_real = f if view_mask is None else jnp.maximum(jnp.sum(view_mask), 1)
    rms = jnp.sqrt(2.0 * cost / (n_real * n))
    return CalibrationResult(intr, dist, poses, rms)
