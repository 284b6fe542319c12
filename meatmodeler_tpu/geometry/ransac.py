"""Massively-batched RANSAC for fundamental/essential matrices.

A north-star capability (BASELINE.json): "RANSAC essential-matrix estimation
and DLT triangulation run as massively-batched hypothesis solves in a single
XLA program". The reference has no RANSAC at all — its geometry leans
entirely on the chessboard; this module provides marker-free two-view
geometry and robust match filtering.

Design: classic RANSAC's sequential hypothesize-test loop is replaced by a
fully parallel sweep — thousands of 8-point hypotheses drawn with
``jax.random``, each solved by the normalized 8-point algorithm (a batched
9x9 symmetric eigenproblem), all scored against all matches by Sampson
distance (one batched matmul pipeline), best-by-inlier-count selected with
an ``argmax``. No data-dependent control flow: one XLA program, matmul-heavy.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp

from meatmodeler_tpu.geometry import so3

__all__ = [
    "RansacResult",
    "find_fundamental",
    "find_essential",
    "recover_pose",
    "refine_relative_pose",
    "estimate_relative_pose",
]


class RansacResult(NamedTuple):
    matrix: jax.Array  # (3, 3) best F or E
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array  # scalar int
    residuals: jax.Array  # (N,) Sampson distances under the best model


def _normalize(pts: jax.Array, mask: jax.Array):
    """Hartley normalization over the valid points only."""
    n = jnp.maximum(jnp.sum(mask), 1)
    centroid = jnp.sum(jnp.where(mask[:, None], pts, 0.0), axis=0) / n
    centered = pts - centroid
    dist = jnp.where(mask, jnp.linalg.norm(centered, axis=1), 0.0)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(dist) / n, 1e-12)
    t = jnp.array(
        [
            [scale, 0.0, -scale * centroid[0]],
            [0.0, scale, -scale * centroid[1]],
            [0.0, 0.0, 1.0],
        ]
    )
    return centered * scale, t


def _eight_point(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Normalized 8-point solve for one hypothesis: (8, 2) x 2 -> (3, 3).

    Operates on already-normalized coordinates; rank-2 enforcement via SVD.
    """
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    one = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # (8, 9)
    ata = a.T @ a
    _, vecs = jnp.linalg.eigh(ata)
    f = vecs[:, 0].reshape(3, 3)
    # Enforce rank 2.
    u, s, vt = jnp.linalg.svd(f)
    s = s.at[2].set(0.0)
    return u @ jnp.diag(s) @ vt


def _sampson(f: jax.Array, p1h: jax.Array, p2h: jax.Array) -> jax.Array:
    """Sampson distance of each correspondence under F. p*h are (N, 3)."""
    fp1 = p1h @ f.T  # (N, 3) = F @ p1
    ftp2 = p2h @ f  # (N, 3) = F^T @ p2
    num = jnp.sum(p2h * fp1, axis=1) ** 2
    den = fp1[:, 0] ** 2 + fp1[:, 1] ** 2 + ftp2[:, 0] ** 2 + ftp2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@partial(jax.jit, static_argnames=("num_hypotheses",))
@matmul_highp
def find_fundamental(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
) -> RansacResult:
    """Batched-RANSAC fundamental matrix.

    Args:
      pts1 / pts2: (N, 2) matched pixel coordinates (padded slots allowed).
      mask: (N,) validity.
      key: PRNG key.
      threshold: inlier Sampson distance in (squared) pixels.
      num_hypotheses: hypotheses solved in parallel.

    Returns:
      RansacResult; ``matrix`` maps pts1 -> epipolar lines in image 2.
    """
    n = pts1.shape[0]
    n1, t1 = _normalize(pts1, mask)
    n2, t2 = _normalize(pts2, mask)

    # Sample 8-subsets biased to valid entries: draw from valid indices via
    # categorical over the mask (duplicates possible but harmless — a
    # degenerate hypothesis simply scores poorly).
    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, logits[None, :], shape=(num_hypotheses, 8)
    )  # (H, 8)

    h1 = n1[idx]  # (H, 8, 2)
    h2 = n2[idx]
    fs = jax.vmap(_eight_point)(h1, h2)  # (H, 3, 3)

    p1h = jnp.concatenate([n1, jnp.ones((n, 1), n1.dtype)], axis=1)
    p2h = jnp.concatenate([n2, jnp.ones((n, 1), n2.dtype)], axis=1)

    # Normalized-space threshold: Sampson in normalized units scales ~ by the
    # normalization scale; score in pixel units by unnormalizing each F.
    def pixel_f(fn):
        return t2.T @ fn @ t1

    fs_px = jax.vmap(pixel_f)(fs)
    p1px = jnp.concatenate([pts1, jnp.ones((n, 1), pts1.dtype)], axis=1)
    p2px = jnp.concatenate([pts2, jnp.ones((n, 1), pts2.dtype)], axis=1)
    d = jax.vmap(lambda f: _sampson(f, p1px, p2px))(fs_px)  # (H, N)
    inl = (d < threshold * threshold) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)

    f_best = fs_px[best]
    res = _sampson(f_best, p1px, p2px)
    inliers = (res < threshold * threshold) & mask

    # Polish: re-solve the 8-point system over ALL inliers (masked rows),
    # iterated with re-gated inliers — a minimal-sample hypothesis alone is
    # far too noisy for narrow baselines (cv2.findFundamentalMat does the
    # same least-squares refinement on the consensus set).
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    one = jnp.ones_like(x1)
    a_all = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # (N, 9)
    for _ in range(2):
        w = inliers.astype(a_all.dtype)[:, None]
        ata = (a_all * w).T @ (a_all * w)
        _, vecs = jnp.linalg.eigh(ata)
        fn = vecs[:, 0].reshape(3, 3)
        u, s, vt = jnp.linalg.svd(fn)
        fn = u @ jnp.diag(s.at[2].set(0.0)) @ vt
        f_ref = pixel_f(fn)
        res_ref = _sampson(f_ref, p1px, p2px)
        inl_ref = (res_ref < threshold * threshold) & mask
        # Keep the polish only if it does not lose consensus.
        better = jnp.sum(inl_ref) >= jnp.sum(inliers)
        f_best = jnp.where(better, f_ref, f_best)
        res = jnp.where(better, res_ref, res)
        inliers = jnp.where(better, inl_ref, inliers)
    return RansacResult(
        matrix=f_best / jnp.where(jnp.abs(f_best[2, 2]) > 1e-12, f_best[2, 2], 1.0),
        inliers=inliers,
        num_inliers=jnp.sum(inliers),
        residuals=jnp.where(mask, res, jnp.inf),
    )


def _project_to_essential(f: jax.Array) -> jax.Array:
    """Nearest essential matrix: singular values -> (s, s, 0), unit norm."""
    u, s, vt = jnp.linalg.svd(f)
    s_mean = 0.5 * (s[0] + s[1])
    e = u @ jnp.diag(jnp.array([s_mean, s_mean, 0.0], f.dtype)) @ vt
    return e / jnp.maximum(jnp.linalg.norm(e), 1e-12)


@partial(jax.jit, static_argnames=("num_hypotheses",))
@matmul_highp
def find_essential(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    intrinsics: jax.Array,
    key: jax.Array,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
) -> RansacResult:
    """Essential matrix via batched RANSAC on normalized rays.

    Unlike the fundamental path, EVERY hypothesis is projected onto the
    essential manifold (singular values (s, s, 0)) *before* scoring — the
    calibrated constraints prune bad 8-point solutions the way cv2's 5-point
    solver does, which matters enormously for clustered matches on narrow
    baselines. The winner is then polished by a Cauchy-IRLS re-solve over
    all matches with per-iteration manifold projection.
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    n1 = (pts1 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n2 = (pts2 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n = n1.shape[0]
    thr = threshold / (0.5 * (fx + fy))  # pixels -> normalized units
    thr2 = thr * thr

    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, 8))

    # Hartley-normalize the rays: clustered matches make the raw 8-point
    # system near-rank-deficient in float32; the solve happens in the
    # conditioned frame and the result maps back before the manifold
    # projection (which must hold in TRUE ray coordinates).
    n1h, t1 = _normalize(n1, mask)
    n2h, t2 = _normalize(n2, mask)

    def solve_one(h1, h2):
        f_h = _eight_point(h1, h2)
        return _project_to_essential(t2.T @ f_h @ t1)

    es = jax.vmap(solve_one)(n1h[idx], n2h[idx])  # (H, 3, 3)

    x1 = jnp.concatenate([n1, jnp.ones((n, 1), n1.dtype)], axis=1)
    x2 = jnp.concatenate([n2, jnp.ones((n, 1), n2.dtype)], axis=1)
    d = jax.vmap(lambda e: _sampson(e, x1, x2))(es)  # (H, N) squared units
    inl = (d < thr2) & mask[None, :]
    best = jnp.argmax(jnp.sum(inl, axis=1))

    e_best = es[best]
    res = _sampson(e_best, x1, x2)
    inliers = (res < thr2) & mask

    # Cauchy-IRLS polish over all matches, re-projected to the manifold
    # each iteration; kept only while consensus does not shrink.
    a_all = jnp.stack(
        [
            n2h[:, 0] * n1h[:, 0],
            n2h[:, 0] * n1h[:, 1],
            n2h[:, 0],
            n2h[:, 1] * n1h[:, 0],
            n2h[:, 1] * n1h[:, 1],
            n2h[:, 1],
            n1h[:, 0],
            n1h[:, 1],
            jnp.ones_like(n1h[:, 0]),
        ],
        axis=-1,
    )  # (N, 9) in the Hartley-conditioned frame
    for _ in range(3):
        # MAD-adaptive Cauchy scale: keep the (tightly clustered) inliers in
        # charge of the re-solve rather than borderline gate survivors.
        med2 = jnp.nanmedian(jnp.where(inliers, res, jnp.nan))
        c2 = jnp.clip((3.0 * 1.4826) ** 2 * med2, 1e-12, thr2)
        w = inliers.astype(a_all.dtype) / (1.0 + res / c2)
        aw = a_all * w[:, None]
        ata = aw.T @ aw
        _, vecs = jnp.linalg.eigh(ata)
        e_ref = _project_to_essential(t2.T @ vecs[:, 0].reshape(3, 3) @ t1)
        res_ref = _sampson(e_ref, x1, x2)
        inl_ref = (res_ref < thr2) & mask
        better = jnp.sum(inl_ref) >= jnp.sum(inliers)
        e_best = jnp.where(better, e_ref, e_best)
        res = jnp.where(better, res_ref, res)
        inliers = jnp.where(better, inl_ref, inliers)

    return RansacResult(
        matrix=e_best,
        inliers=inliers,
        num_inliers=jnp.sum(inliers),
        residuals=jnp.where(mask, res, jnp.inf),
    )


@matmul_highp
def _triangulate_midpoint(rot: jax.Array, tvec: jax.Array, n1: jax.Array, n2: jax.Array):
    """Closed-form two-ray midpoint triangulation in NORMALIZED coordinates.

    Solves min_{z1,z2} |z1 R d1 - (z2 d2 - t)|^2 per point — a 2x2 normal
    system with a closed-form inverse, i.e. pure elementwise arithmetic.
    This exists because the DLT path (``triangulate_pairs``) runs one tiny
    eigendecomposition PER POINT: batched 4x4 factorizations are serial
    QR-iteration work, and the RANSAC scoring loop calls triangulation ~40x
    per bootstrap (4 cheirality candidates x top-k hypotheses + the
    candidate scores) — most of the marker-free chain's time. Scoring only needs depth SIGNS and coarse
    reprojections, which the midpoint gives at ~100x less device time; the
    production n-view triangulation stage keeps the DLT.

    Returns (X (N, 3) midpoints in camera-1 frame, z1 (N,), z2 (N,)).
    Near-parallel rays (|det| ~ 0) return z = 0 — callers treat them as
    cheirality failures, matching the DLT's behaviour on those points.
    """
    one = jnp.ones_like(n1[:, :1])
    d1 = jnp.concatenate([n1, one], axis=1)
    d2 = jnp.concatenate([n2, one], axis=1)
    rd1 = d1 @ rot.T  # R d1, per point
    a11 = jnp.sum(rd1 * rd1, axis=1)
    a12 = -jnp.sum(rd1 * d2, axis=1)
    a22 = jnp.sum(d2 * d2, axis=1)
    # A^T b with A = [R d1, -d2], b = -t.
    b1 = -jnp.sum(rd1 * tvec[None, :], axis=1)
    b2 = jnp.sum(d2 * tvec[None, :], axis=1)
    det = a11 * a22 - a12 * a12
    safe_det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    z1 = (a22 * b1 - a12 * b2) / safe_det
    z2 = (a11 * b2 - a12 * b1) / safe_det
    bad = jnp.abs(det) < 1e-12
    z1 = jnp.where(bad, 0.0, z1)
    z2 = jnp.where(bad, 0.0, z2)
    # Midpoint between the two closest ray points, in camera-1 frame.
    x1 = z1[:, None] * d1
    x2_in1 = (z2[:, None] * d2 - tvec[None, :]) @ rot
    return 0.5 * (x1 + x2_in1), z1, z2


@matmul_highp
def recover_pose(
    essential: jax.Array,
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    intrinsics: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Disambiguate E into (R, t) by cheirality voting (cv2.recoverPose).

    Returns (rvec (3,), t unit (3,), votes (4,)) — the winning decomposition
    among the four candidates, scored by how many inlier points land in
    front of both cameras.
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    n1 = (pts1 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n2 = (pts2 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])

    u, _, vt = jnp.linalg.svd(essential)
    # Proper rotations.
    d1 = jnp.linalg.det(u) * jnp.linalg.det(vt)
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt * jnp.where(d1 < 0, -1.0, 1.0)
    r2 = u @ w.T @ vt * jnp.where(d1 < 0, -1.0, 1.0)
    t = u[:, 2]

    def depths(r, tv):
        # Closed-form midpoint depths: only the SIGNS matter here, and the
        # 2x2 solve avoids a per-point DLT factorization (see
        # _triangulate_midpoint's rationale).
        _, z1, z2 = _triangulate_midpoint(r, tv, n1, n2)
        return jnp.sum((z1 > 0) & (z2 > 0) & mask)

    cands = [(r1, t), (r1, -t), (r2, t), (r2, -t)]
    votes = jnp.stack([depths(r, tv) for r, tv in cands])
    best = jnp.argmax(votes)
    rs = jnp.stack([so3.log(r) for r, _ in cands])
    ts = jnp.stack([tv for _, tv in cands])
    return rs[best], ts[best], votes


@jax.jit
@matmul_highp
def refine_relative_pose(
    rvec: jax.Array,
    tvec: jax.Array,
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    intrinsics: jax.Array,
    iters: int = 15,
) -> Tuple[jax.Array, jax.Array]:
    """Gauss-Newton refinement of (R, t) on the essential manifold.

    Minimizes the Sampson error of E(R, t) = [t]_x R over the inlier
    correspondences — the step cv2's 5-point RANSAC effectively gets from
    enforcing the essential constraints per hypothesis, which a projected
    8-point winner lacks (its translation direction can be tens of degrees
    off on narrow baselines even with sub-pixel matches). Levenberg damping
    handles the t-scale gauge freedom; t is renormalized every step.

    Returns the refined (rvec, unit tvec).
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    n1 = (pts1 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n2 = (pts2 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n = pts1.shape[0]
    x1 = jnp.concatenate([n1, jnp.ones((n, 1), n1.dtype)], axis=1)
    x2 = jnp.concatenate([n2, jnp.ones((n, 1), n2.dtype)], axis=1)
    w_mask = mask.astype(n1.dtype)
    focal = 0.5 * (fx + fy)
    # Floor for the adaptive Cauchy scale: 0.05 px.
    c2_floor = jnp.asarray(0.05**2, n1.dtype)

    def raw_residual(params):
        rot = so3.exp(params[:3])
        t = params[3:]
        tx = jnp.array(
            [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]],
            params.dtype,
        )
        e = tx @ rot
        ex1 = x1 @ e.T
        etx2 = x2 @ e
        num = jnp.sum(x2 * ex1, axis=1)
        den = jnp.sqrt(
            jnp.maximum(
                ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2,
                1e-12,
            )
        )
        # Pixel-scaled Sampson: residuals of O(0.1-1) keep the float32
        # normal equations well away from the round-off floor (ray-unit
        # residuals of ~1e-4 make J^T J ~1e-8 — any absolute damping then
        # swamps it and Gauss-Newton silently stalls).
        return focal * num / den

    def irls_weights(params):
        r = raw_residual(params)
        # Cauchy robust weights with a MAD-adaptive scale. A fixed scale far
        # above the inlier noise lets a handful of outliers dominate the
        # robust cost (each contributes ~c^2) and drag the pose away from
        # the inlier optimum; scaling by the measured spread keeps the
        # inliers in charge.
        med = jnp.nanmedian(jnp.where(mask, jnp.abs(r), jnp.nan))
        c2 = jnp.maximum((3.0 * 1.4826 * med) ** 2, c2_floor)
        return w_mask / (1.0 + (r * r) / c2)

    def cost(params, w):
        r = raw_residual(params)
        return jnp.sum(w * r * r)

    def body(_, carry):
        params, lam = carry
        w = irls_weights(params)
        sw = jnp.sqrt(w)[:, None]
        j = jax.jacfwd(raw_residual)(params) * sw  # (N, 6)
        r = raw_residual(params) * sw[:, 0]
        jtj = j.T @ j
        g = j.T @ r
        # Marquardt scaling: damp relative to the problem's own curvature.
        damp = lam * (jnp.trace(jtj) / 6.0 + 1e-12)
        step = jnp.linalg.solve(jtj + damp * jnp.eye(6, dtype=params.dtype), g)
        cand = params - step
        cand = cand.at[3:].set(cand[3:] / jnp.maximum(jnp.linalg.norm(cand[3:]), 1e-12))
        better = cost(cand, w) < cost(params, w)
        params = jnp.where(better, cand, params)
        lam = jnp.where(better, jnp.maximum(lam * 0.3, 1e-8), lam * 10.0)
        return params, lam

    params0 = jnp.concatenate(
        [jnp.asarray(rvec, n1.dtype), jnp.asarray(tvec, n1.dtype)]
    )
    params0 = params0.at[3:].set(
        params0[3:] / jnp.maximum(jnp.linalg.norm(params0[3:]), 1e-12)
    )
    params, _ = jax.lax.fori_loop(0, iters, body, (params0, jnp.asarray(1e-4, n1.dtype)))
    return params[:3], params[3:]


@partial(jax.jit, static_argnames=("num_hypotheses", "top_k"))
@matmul_highp
def estimate_relative_pose(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    intrinsics: jax.Array,
    key: jax.Array,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
    top_k: int = 16,
) -> Tuple[jax.Array, jax.Array, RansacResult]:
    """LO-RANSAC relative pose: batched hypotheses + batched local refinement.

    Gauss-Newton on the essential manifold is local, and a single RANSAC
    winner routinely sits in the wrong basin on narrow baselines (its
    translation direction can be ~90 degrees off while its epipolar residuals
    look fine). So the top-``top_k`` hypotheses by consensus are each
    decomposed (cheirality vote), refined with the robust manifold GN — all
    ``vmap``-batched, the data-parallel replacement for cv2's sequential
    LO-RANSAC loop — and the refined candidate with the largest consensus
    (robust cost as tie-break) wins.

    Returns (rvec, unit tvec, RansacResult under the winning pose).
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    n1 = (pts1 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n2 = (pts2 - jnp.stack([cx, cy])) / jnp.stack([fx, fy])
    n = n1.shape[0]
    thr2 = (threshold / (0.5 * (fx + fy))) ** 2

    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, 8))
    n1h, t1 = _normalize(n1, mask)
    n2h, t2 = _normalize(n2, mask)

    def solve_one(h1, h2):
        return _project_to_essential(t2.T @ _eight_point(h1, h2) @ t1)

    es = jax.vmap(solve_one)(n1h[idx], n2h[idx])
    x1 = jnp.concatenate([n1, jnp.ones((n, 1), n1.dtype)], axis=1)
    x2 = jnp.concatenate([n2, jnp.ones((n, 1), n2.dtype)], axis=1)
    d = jax.vmap(lambda e: _sampson(e, x1, x2))(es)
    counts = jnp.sum((d < thr2) & mask[None, :], axis=1)
    _, top_idx = jax.lax.top_k(counts, top_k)

    def localize(e):
        inl = (_sampson(e, x1, x2) < thr2) & mask
        rv, tv, _ = recover_pose(e, pts1, pts2, inl, intrinsics)
        rv, tv = refine_relative_pose(rv, tv, pts1, pts2, mask, intrinsics)
        return rv, tv

    rvs, tvs = jax.vmap(localize)(es[top_idx])  # (K, 3) each

    # Planar-degeneracy escape hatch: the 8-point family above fails
    # systematically on (quasi-)planar scenes — every hypothesis lands in
    # the same wrong basin. A RANSAC homography decomposes into up to 8
    # pose candidates that DO cover the true basin there (ORB-SLAM's dual
    # H/F bootstrap); refine them with the same GN and let the common
    # cheirality/MSAC score arbitrate between the two families.
    key_h = jax.random.fold_in(key, 1)
    h_res = find_homography_ransac(pts1, pts2, mask, key_h, threshold=3.0)
    rv_h, tv_h = _decompose_homography(h_res.matrix, intrinsics)
    rv_h = jnp.nan_to_num(rv_h)
    tv_h = jnp.nan_to_num(tv_h)

    def refine_h(rv, tv):
        return refine_relative_pose(rv, tv, pts1, pts2, mask, intrinsics)

    rv_hr, tv_hr = jax.vmap(refine_h)(rv_h, tv_h)
    rvs = jnp.concatenate([rvs, rv_hr])
    tvs = jnp.concatenate([tvs, tv_hr])

    def score(rv, tv):
        rot = so3.exp(rv)
        tx = jnp.array(
            [[0.0, -tv[2], tv[1]], [tv[2], 0.0, -tv[0]], [-tv[1], tv[0], 0.0]],
            tv.dtype,
        )
        e = tx @ rot
        e = e / jnp.maximum(jnp.linalg.norm(e), 1e-12)
        res = _sampson(e, x1, x2)
        inl = (res < thr2) & mask
        # The Sampson cost is blind to the twisted-pair twin — decompose and
        # cheirality-vote to pin the candidate to its in-front twin.
        rvd, tvd, _ = recover_pose(e, pts1, pts2, inl, intrinsics)

        # Score by TRIANGULATED REPROJECTION, not epipolar distance: a
        # (quasi-)planar point set is consistent with a whole family of
        # epipolar geometries — every member zeroes the Sampson error on the
        # plane, so MSAC/cheirality cannot tell the true pose from the
        # planar-degenerate impostors (measured: compact-object bootstraps
        # picked poses whose triangulated scene depth was 4-5x off while
        # out-scoring the truth on Sampson). The depth RELIEF only shows up
        # after triangulation: the wrong family member reprojects off-plane
        # points with errors proportional to the relief (ORB-SLAM's
        # CheckRT-style scoring).
        rd = so3.exp(rvd)
        # Midpoint triangulation (closed-form 2x2 per point) — the scoring
        # only needs depth signs + coarse reprojections, and the DLT here
        # cost ~0.3 s per vmapped candidate batch (see _triangulate_midpoint).
        x3, z1, z2 = _triangulate_midpoint(rd, tvd, n1, n2)
        xc2 = x3 @ rd.T + tvd
        safe1 = jnp.where(jnp.abs(z1) > 1e-9, z1, 1e-9)
        safe2 = jnp.where(jnp.abs(z2) > 1e-9, z2, 1e-9)
        r1 = jnp.sum((x3[:, :2] / safe1[:, None] - n1) ** 2, axis=1)
        r2 = jnp.sum((xc2[:, :2] / safe2[:, None] - n2) ** 2, axis=1)
        rmax = jnp.maximum(r1, r2)
        good = mask & (z1 > 1e-6) & (z2 > 1e-6) & (rmax < rthr2)
        msac_r = jnp.sum(jnp.where(mask, jnp.minimum(rmax, rthr2), 0.0))
        return jnp.sum(good), msac_r, rvd, tvd, e, res, inl

    rthr2 = 4.0 * thr2  # reprojection gate: 2x the epipolar gate, squared
    n_good, msacs, rvds, tvds, es_ref, ress, inls = jax.vmap(score)(rvs, tvs)
    # Most triangulated-and-reprojected inliers win; truncated reprojection
    # cost breaks ties.
    order = n_good.astype(jnp.float32) - msacs / (jnp.max(msacs) + 1e-30)
    best = jnp.argmax(order)
    n_inl = jnp.sum(inls, axis=1)

    result = RansacResult(
        matrix=es_ref[best],
        inliers=inls[best],
        num_inliers=n_inl[best],
        residuals=jnp.where(mask, ress[best], jnp.inf),
    )
    return rvds[best], tvds[best], result


def _decompose_homography(h: jax.Array, intrinsics: jax.Array):
    """Faugeras SVD decomposition of a pixel homography into 8 (R, t) poses.

    For (quasi-)planar scenes the 8-point essential systematically lands in
    a wrong basin (the classic planar degeneracy) while the homography is
    well-conditioned; its decomposition supplies the pose candidates the
    epipolar path cannot (ORB-SLAM's H/F dual bootstrap). Invalid candidates
    are culled downstream by the cheirality vote.

    Returns (rvecs (8, 3), tvecs (8, 3) unit-norm).
    """
    kinv = jnp.linalg.inv(intrinsics)
    hn = kinv @ h @ intrinsics
    u, d, vt = jnp.linalg.svd(hn)
    d1, d2, d3 = d[0], d[1], d[2]
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    x3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    d2s = jnp.maximum(d2, 1e-12)

    rvecs, tvecs = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            a1, a3 = e1 * x1, e3 * x3
            # Case d' = +d2: rotation about the y-axis of the V frame.
            sin_t = (d1 - d3) / d2s * a1 * a3
            cos_t = (d1 * a3 * a3 + d3 * a1 * a1) / d2s
            rp = jnp.array(
                [[cos_t, 0.0, -sin_t], [0.0, 1.0, 0.0], [sin_t, 0.0, cos_t]]
            )
            tp = jnp.array([a1, 0.0, -a3]) * (d1 - d3)
            rot = s * u @ rp @ vt
            t = u @ tp
            rvecs.append(so3.log(rot))
            tvecs.append(t / jnp.maximum(jnp.linalg.norm(t), 1e-12))
            # Case d' = -d2: adds a 180-degree flip.
            sin_p = (d1 + d3) / d2s * a1 * a3
            cos_p = (d3 * a1 * a1 - d1 * a3 * a3) / d2s
            rp2 = jnp.array(
                [[cos_p, 0.0, sin_p], [0.0, -1.0, 0.0], [sin_p, 0.0, -cos_p]]
            )
            tp2 = jnp.array([a1, 0.0, a3]) * (d1 + d3)
            rot2 = s * u @ rp2 @ vt
            t2 = u @ tp2
            rvecs.append(so3.log(rot2))
            tvecs.append(t2 / jnp.maximum(jnp.linalg.norm(t2), 1e-12))
    return jnp.stack(rvecs), jnp.stack(tvecs)


def _homography_transfer_sq(h: jax.Array, pts1: jax.Array, pts2: jax.Array):
    """Symmetric transfer error (squared px) of pts1 <-H-> pts2."""
    n = pts1.shape[0]
    one = jnp.ones((n, 1), pts1.dtype)
    p1h = jnp.concatenate([pts1, one], axis=1)
    p2h = jnp.concatenate([pts2, one], axis=1)
    f = p1h @ h.T
    fwd = f[:, :2] / jnp.where(jnp.abs(f[:, 2:]) > 1e-12, f[:, 2:], 1e-12)
    hinv = jnp.linalg.inv(h)
    b = p2h @ hinv.T
    bwd = b[:, :2] / jnp.where(jnp.abs(b[:, 2:]) > 1e-12, b[:, 2:], 1e-12)
    return jnp.sum((fwd - pts2) ** 2, 1) + jnp.sum((bwd - pts1) ** 2, 1)


@partial(jax.jit, static_argnames=("num_hypotheses",))
@matmul_highp
def find_homography_ransac(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    threshold: float = 3.0,
    num_hypotheses: int = 1024,
) -> RansacResult:
    """Batched-RANSAC planar homography (4-point DLT hypotheses), polished
    by an inlier-weighted DLT re-solve. ``residuals`` are the symmetric
    transfer errors (squared px)."""
    from meatmodeler_tpu.geometry.homography import find_homography

    n = pts1.shape[0]
    thr2 = threshold * threshold
    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, 4))
    hs = jax.vmap(lambda a, b: find_homography(a, b))(pts1[idx], pts2[idx])

    d = jax.vmap(lambda h: _homography_transfer_sq(h, pts1, pts2))(hs)
    counts = jnp.sum((d < thr2) & mask[None, :], axis=1)
    best = jnp.argmax(counts)
    h_best = hs[best]
    res = _homography_transfer_sq(h_best, pts1, pts2)
    inliers = (res < thr2) & mask

    # Weighted-DLT polish over the consensus set.
    x, y = pts1[:, 0], pts1[:, 1]
    uu, vv = pts2[:, 0], pts2[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows_u = jnp.stack([-x, -y, -one, zero, zero, zero, uu * x, uu * y, uu], axis=-1)
    rows_v = jnp.stack([zero, zero, zero, -x, -y, -one, vv * x, vv * y, vv], axis=-1)
    for _ in range(2):
        w = inliers.astype(x.dtype)[:, None]
        design = jnp.concatenate([rows_u * w, rows_v * w], axis=0)
        ata = design.T @ design
        _, vecs = jnp.linalg.eigh(ata)
        h_ref = vecs[:, 0].reshape(3, 3)
        h_ref = h_ref / jnp.where(jnp.abs(h_ref[2, 2]) > 1e-12, h_ref[2, 2], 1.0)
        res_ref = _homography_transfer_sq(h_ref, pts1, pts2)
        inl_ref = (res_ref < thr2) & mask
        better = jnp.sum(inl_ref) >= jnp.sum(inliers)
        h_best = jnp.where(better, h_ref, h_best)
        res = jnp.where(better, res_ref, res)
        inliers = jnp.where(better, inl_ref, inliers)

    return RansacResult(
        matrix=h_best,
        inliers=inliers,
        num_inliers=jnp.sum(inliers),
        residuals=jnp.where(mask, res, jnp.inf),
    )
