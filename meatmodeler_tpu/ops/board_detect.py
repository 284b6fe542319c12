"""On-device chessboard detection.

On-device replacement for ``cv2.findChessboardCorners`` (call sites
``processor.py:315, 319, 369``) — the one compute stage SURVEY.md §7.3.5
deferred to host OpenCV ("genuinely hard to do well on-device ... revisit
later"). The design inverts the classic sequential grow-a-grid detectors into
two batched device stages:

  1. **Saddle candidates**: chessboard inner corners are intensity saddle
     points, so ``det(Hessian) < 0`` with large magnitude. A smoothed Hessian
     response -> non-max suppression -> static top-k gives K candidate
     corners with sub-pixel (parabolic) peak refinement — the same
     static-shape pattern as ``ops.features.good_features``.
  2. **Batched grid-fit RANSAC**: every ordered 4-tuple of the strongest
     candidates is hypothesized to be the grid's four outer corners. Each
     hypothesis yields a closed-form 4-point homography (projective-basis
     construction: two 3x3 adjugate solves, no iterative linear algebra),
     the full ``cols x rows`` grid is projected through it, and the
     hypothesis is scored by nearest-candidate assignment: a real chessboard
     must place ALL inner corners on detected saddles, injectively, within
     tolerance. All hypotheses solve and score in one XLA program — the
     "massively-batched hypothesis solves" idiom the north star prescribes
     for RANSAC, applied to detection.

A board that is absent simply produces no hypothesis with a full injective
assignment, so ``ok=False`` comes out of the same program — no host branch.
Corner order matches OpenCV's row-major-over-pattern convention that
calibration and pose estimation rely on; the 180-degree/winding ambiguities
are resolved downstream exactly as for the host detector
(``ops.chessboard.canonicalize_corners`` / ``orient_corners_to``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meatmodeler_tpu.ops.features import _conv2

__all__ = ["BoardDetection", "saddle_response", "saddle_candidates", "find_chessboard_device"]


class BoardDetection(NamedTuple):
    corners: jax.Array  # (rows*cols, 2) float32 (x, y), row-major over pattern
    ok: jax.Array  # () bool — a full injective grid assignment was found
    residual: jax.Array  # () mean |projected grid - matched candidate| (px)


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _smooth(img: jax.Array) -> jax.Array:
    """5x5 binomial blur (separable), applied twice — ~Gaussian sigma 1.6.

    Enough support to kill pixel noise while keeping the saddle structure
    (a few px around the corner) intact.
    """
    kx = jnp.asarray(_BINOMIAL5, img.dtype)[None, :]
    for _ in range(2):
        img = _conv2(img, kx)
        img = _conv2(img, kx.T)
    return img


def saddle_response(grey: jax.Array) -> jax.Array:
    """Negative-Hessian-determinant saddle strength, >0 at X-corners.

    At a chessboard inner corner the intensity surface is a saddle: the
    Hessian has eigenvalues of opposite sign, so ``-det(H) = Ixy^2 - Ixx*Iyy``
    is large and positive; on edges and blobs it is <= 0.
    """
    img = _smooth(jnp.asarray(grey, jnp.float32))
    d2 = jnp.asarray([[1.0, -2.0, 1.0]], img.dtype)
    ixx = _conv2(img, d2)
    iyy = _conv2(img, d2.T)
    dxy = jnp.asarray([[0.25, 0.0, -0.25], [0.0, 0.0, 0.0], [-0.25, 0.0, 0.25]], img.dtype)
    ixy = _conv2(img, dxy)
    return ixy * ixy - ixx * iyy


class _Candidates(NamedTuple):
    xy: jax.Array  # (K, 2) float32, parabola-refined peak positions
    score: jax.Array  # (K,)
    mask: jax.Array  # (K,) bool


@partial(jax.jit, static_argnames=("max_candidates", "nms_window", "exact_topk"))
def saddle_candidates(
    grey: jax.Array,
    max_candidates: int = 24,
    nms_window: int = 7,
    rel_threshold: float = 0.1,
    exact_topk: bool = False,
) -> _Candidates:
    """Top-k saddle points with sub-pixel parabolic refinement.

    ``exact_topk=False`` ranks with a 4x-oversampled ``approx_max_k``
    refined by an exact sort of the survivors: a true
    top-``max_candidates`` saddle is lost only if it shares a reduction bin
    with a stronger element AND falls outside the 4x oversample — board
    detection needs ALL pattern corners among the candidates, so the
    oversample keeps the approximation safe. ``True`` forces plain
    ``lax.top_k`` (the original behavior) for debugging missed detections.
    """
    resp = saddle_response(grey)
    h, w = resp.shape

    neighborhood = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (nms_window, nms_window), (1, 1), "SAME"
    )
    valid = (resp >= neighborhood) & (resp > rel_threshold * jnp.max(resp)) & (resp > 0)

    margin = 3
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid &= (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)

    flat = jnp.where(valid, resp, -jnp.inf).reshape(-1)
    if exact_topk:
        top_resp, top_idx = jax.lax.top_k(flat, max_candidates)
    else:
        k_over = min(4 * max_candidates, flat.shape[0])
        over_resp, over_idx = jax.lax.approx_max_k(flat, k_over)
        top_resp, sel = jax.lax.top_k(over_resp, max_candidates)
        top_idx = over_idx.astype(jnp.int32)[sel]
    ys = top_idx // w
    xs = top_idx % w
    mask = jnp.isfinite(top_resp)

    # Parabolic peak interpolation per axis: offset = (f- - f+) / (2(f- - 2f0 + f+)).
    def axis_offset(minus, center, plus):
        denom = minus - 2.0 * center + plus
        off = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (minus - plus) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    def sample(dy, dx):
        return resp[jnp.clip(ys + dy, 0, h - 1), jnp.clip(xs + dx, 0, w - 1)]

    c0 = sample(0, 0)
    off_x = axis_offset(sample(0, -1), c0, sample(0, 1))
    off_y = axis_offset(sample(-1, 0), c0, sample(1, 0))
    xy = jnp.stack([xs.astype(jnp.float32) + off_x, ys.astype(jnp.float32) + off_y], axis=-1)
    return _Candidates(xy=xy, score=jnp.where(mask, top_resp, 0.0), mask=mask)


def _basis_homography(p: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Closed-form homography sending the projective basis e1,e2,e3,(1,1,1)
    to the four 2D points ``p`` (4, 2). Returns (H, ok)."""
    ph = jnp.concatenate([p, jnp.ones((4, 1), p.dtype)], axis=1)  # (4, 3)
    m = ph[:3].T  # columns are p1 p2 p3
    # Adjugate solve: lam = adj(M) @ p4 / det(M).
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    adj = jnp.stack([jnp.cross(b, c), jnp.cross(c, a), jnp.cross(a, b)])  # rows
    det = jnp.dot(adj[0], a)
    lam = adj @ ph[3]
    ok = (jnp.abs(det) > 1e-8) & jnp.all(jnp.abs(lam) > 1e-8 * jnp.abs(det))
    h = m * lam[None, :]  # columns scaled; maps basis -> p_i up to det factor
    return h, ok


def _grid_constants(pattern: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(inv basis->domain homography, homogeneous grid points) — host consts."""
    cols, rows = pattern
    dom = np.array(
        [[0.0, 0.0], [cols - 1.0, 0.0], [0.0, rows - 1.0], [cols - 1.0, rows - 1.0]]
    )
    ph = np.concatenate([dom, np.ones((4, 1))], axis=1)
    m = ph[:3].T
    lam = np.linalg.solve(m, ph[3])
    h_dom = m * lam[None, :]
    gx, gy = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(cols * rows)], axis=1)  # (G, 3)
    return np.linalg.inv(h_dom), grid


@partial(
    jax.jit,
    static_argnames=(
        "pattern", "max_candidates", "hyp_candidates", "nms_window", "exact_topk",
    ),
)
def find_chessboard_device(
    grey: jax.Array,
    pattern: Tuple[int, int] = (4, 3),
    max_candidates: int = 24,
    hyp_candidates: int = 16,
    tol: float = 3.0,
    nms_window: int = 7,
    exact_topk: bool = False,
) -> BoardDetection:
    """Detect the full inner-corner grid on device. One XLA program.

    Args:
      grey: (H, W) grey image (any float/uint scale).
      pattern: (cols, rows) inner corners, as for cv2.
      max_candidates: saddle candidates kept for assignment (static).
      hyp_candidates: strongest candidates enumerated as hypothesis corners
        (static; hypotheses = hyp_candidates**4, batched in one program).
      tol: max px distance between a projected grid point and its candidate.

    Returns:
      BoardDetection(corners, ok, residual). ``corners`` is row-major over
      the pattern like OpenCV (x fastest), positions taken from the matched
      saddle candidates (not the homography projection).
    """
    cols, rows = pattern
    g = cols * rows
    if max_candidates < g:
        raise ValueError(
            f"max_candidates={max_candidates} cannot cover the {g}-corner pattern"
        )
    # Hypothesis corners index into the candidate arrays; more hypothesis
    # slots than candidates would be silently clamped by JAX gathers into
    # degenerate coincident-point tuples.
    hyp_candidates = min(hyp_candidates, max_candidates)
    cand = saddle_candidates(
        grey,
        max_candidates=max_candidates,
        nms_window=nms_window,
        exact_topk=exact_topk,
    )
    inv_dom, grid = _grid_constants(pattern)
    inv_dom = jnp.asarray(inv_dom, jnp.float32)
    grid = jnp.asarray(grid, jnp.float32)

    m = hyp_candidates
    hyp = jnp.arange(m**4, dtype=jnp.int32)
    ia = hyp // (m**3)
    ib = (hyp // (m**2)) % m
    ic = (hyp // m) % m
    idd = hyp % m
    idx4 = jnp.stack([ia, ib, ic, idd], axis=1)  # (N, 4)

    cand_xy = cand.xy
    cand_valid = cand.mask
    # Relative saddle strength drives hypothesis selection: the board's inner
    # X-corners are several times stronger than the L-junctions along the
    # board boundary, and a projective grid through boundary saddles can
    # otherwise fit within tolerance (9 true + 3 boundary corners is a valid
    # homography!) and win on distance alone.
    norm_score = cand.score / jnp.maximum(jnp.max(cand.score), 1e-12)
    big = jnp.float32(1e9)
    # Invalid candidates are parked far away AND far apart, so they can never
    # match a grid point nor silently coincide.
    park = big * (1.0 + jnp.arange(max_candidates, dtype=jnp.float32))[:, None]
    cand_pos = jnp.where(cand_valid[:, None], cand_xy, park)

    def score_hyp(ids):
        p4 = cand_pos[ids]  # (4, 2)
        distinct = (
            (ids[0] != ids[1])
            & (ids[0] != ids[2])
            & (ids[0] != ids[3])
            & (ids[1] != ids[2])
            & (ids[1] != ids[3])
            & (ids[2] != ids[3])
        )
        usable = distinct & jnp.all(cand_valid[ids])
        # Guard the homography against parked/degenerate points.
        p4c = jnp.clip(p4, -1e6, 1e6)
        hb, hok = _basis_homography(p4c)
        h = hb @ inv_dom  # grid coords -> image
        proj = grid @ h.T  # (G, 3)
        z = proj[:, 2]
        zok = jnp.all(jnp.abs(z) > 1e-8)
        pts = proj[:, :2] / jnp.where(jnp.abs(z) > 1e-8, z, 1.0)[:, None]

        d2 = jnp.sum((pts[:, None, :] - cand_pos[None, :, :]) ** 2, axis=-1)  # (G, K)
        md2 = jnp.min(d2, axis=1)
        nearest = jnp.argmin(d2, axis=1)
        dmin = jnp.sqrt(md2)
        matched = dmin < tol
        # Scatter-free injectivity (no 1-element scatter per hypothesis x
        # 65k hypotheses): candidate k is
        # hit iff it is the FIRST minimizer of some matched grid point —
        # d2 is only (G, K), so the one-hot reduction is free.
        is_near = d2 <= md2[:, None]
        first_near = jnp.cumsum(is_near, axis=1) == 1
        hit = jnp.any(is_near & first_near & matched[:, None], axis=0)
        injective = jnp.sum(hit) == g
        full = jnp.sum(matched) == g
        ok = usable & hok & zok & full & injective
        total = jnp.sum(jnp.where(matched, dmin, tol))
        strength = jnp.sum(jnp.where(matched, norm_score[nearest], 0.0))
        # Lexicographic-ish objective: maximize matched saddle strength first
        # (weight >> the max possible distance spread), break ties by
        # geometric residual.
        objective = total + (g - strength) * (8.0 * tol)
        return jnp.where(ok, objective, jnp.inf), total, nearest

    # Chunked evaluation: bounds the (chunk, G, K) distance tensor while all
    # chunks still compile into one program (lax.map).
    n = idx4.shape[0]
    chunk = 1024
    pad = (-n) % chunk
    idx4 = jnp.concatenate([idx4, jnp.zeros((pad, 4), jnp.int32)]) if pad else idx4
    objectives, totals, nearests = jax.lax.map(jax.vmap(score_hyp), idx4.reshape(-1, chunk, 4))
    objectives = objectives.reshape(-1)[:n]
    totals = totals.reshape(-1)[:n]
    nearests = nearests.reshape(-1, g)[:n]
    best = jnp.argmin(objectives)
    ok = jnp.isfinite(objectives[best])
    corners = cand_xy[nearests[best]]
    return BoardDetection(corners=corners, ok=ok, residual=totals[best] / g)
