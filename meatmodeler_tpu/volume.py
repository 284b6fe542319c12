"""Volume estimation — the capability the reference promised but never built.

``README.md:2`` promises "estimate the items volume"; no reference code
computes one (SURVEY.md §0.2). BASELINE.json makes device-side
voxel-carving / convex-hull volume a required capability. Two estimators,
both running as single XLA programs over the HBM-resident cloud:

  * ``convex_hull_volume`` — the hull is approximated from the *outside* as
    an intersection of half-spaces: sample D directions, compute the support
    value h(d) = max_p <p, d> (one (P, D) matmul), then count voxels v with
    <v, d> <= h(d) for all d (one (V, D) matmul) — two matmuls, exact in
    the D -> inf limit, monotonically decreasing in D.
  * ``carved_volume`` — classic voxel carving against per-view silhouettes:
    splat the item's projected points into each keyframe, dilate, and keep
    voxels whose projections land inside every view's mask.
  * ``hull_and_carved_volume`` — the pipeline's estimator: one carve, then
    the hull as (robust symmetric completion of the seen surface) ∩ (visual
    hull); neither a sparse-point hull nor a silhouette carve alone can
    estimate volume from a one-sided view wedge (see its docstring for the
    measured failures of both).

Plus ``split_item_points``: the board-anchored world frame (PnP against the
X-Z chessboard, y = 0 plane, ``processor.py:162-166``) makes separating the
item trivial — its points float above the plane (negative y in OpenCV's
y-down convention).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from meatmodeler_tpu.utils.precision import matmul_highp
import numpy as np

__all__ = [
    "split_item_points",
    "convex_hull_volume",
    "carved_volume",
    "hull_and_carved_volume",
]


@partial(jax.jit, static_argnames=("plane_margin", "knn", "use_plane"))
@matmul_highp
def split_item_points(
    points: jax.Array,
    mask: jax.Array,
    plane_margin: float = 0.3,
    knn: int = 6,
    use_plane: bool = True,
):
    """Mask of points belonging to the item: above the board plane
    (y < -margin), densely clustered, and not part of a far tail.

    The hull volume is set entirely by extreme points, so sparse
    mis-triangulated outliers inflate it cubically. Two robust gates:

      1. k-NN density: an item point sits in a cluster, so its k-th nearest
         neighbour is close; an isolated outlier's is not. (One (P, P)
         distance matrix — one matmul at these sizes.)
      2. median +- MAD on distance-to-centroid, which unlike quantiles does
         not move into a fat tail.

    ``use_plane=False`` skips the board-plane gate — the marker-free path,
    where the world frame is keyframe 0's camera (no y = 0 plane exists);
    the density and MAD gates then do all the splitting.
    """
    above = points[:, 1] < -plane_margin if use_plane else jnp.ones(points.shape[0], bool)
    keep = mask & above
    n_keep = jnp.maximum(jnp.sum(keep), 1)

    # --- k-NN density gate ---
    big = jnp.float32(1e9)
    sq = jnp.sum(points * points, axis=1)
    # This expansion is catastrophically cancellation-prone: |p|^2 ~ 600 at
    # the bench scene while k-NN distances^2 ~ 0.01-0.25, so a default
    # reduced-precision matmul (TF32 on the GPU, ~0.05% relative; bf16
    # passes, ~0.4%) buries the density gate in noise, chopping the item's
    # rim and the hull with it. matmul_highp on this function pins the
    # product to full f32.
    d2 = sq[:, None] + sq[None, :] - 2.0 * (points @ points.T)
    d2 = jnp.where(keep[None, :], d2, big)  # only candidate neighbours count
    d2 = d2 + jnp.where(jnp.eye(points.shape[0], dtype=bool), big, 0.0)
    # Degenerate reconstructions can hand in fewer points than `knn`.
    k_eff = min(knn, points.shape[0])
    neg_topk, _ = jax.lax.top_k(-d2, k_eff)  # k smallest distances
    dk = jnp.sqrt(jnp.maximum(-neg_topk[:, -1], 0.0))  # k-th NN distance
    dk_kept = jnp.where(keep, dk, jnp.nan)
    dk_med = jnp.nan_to_num(jnp.nanmedian(dk_kept), nan=1.0)
    keep = keep & (dk <= 3.0 * dk_med)

    # --- centroid-distance MAD gate ---
    center = jnp.sum(jnp.where(keep[:, None], points, 0.0), axis=0) / jnp.maximum(
        jnp.sum(keep), 1
    )
    d = jnp.linalg.norm(points - center, axis=1)
    d_kept = jnp.where(keep, d, jnp.nan)
    med = jnp.nan_to_num(jnp.nanmedian(d_kept), nan=1.0)
    mad = jnp.nan_to_num(jnp.nanmedian(jnp.abs(d_kept - med)), nan=0.5)
    return keep & (d <= med + 4.0 * mad)


def _fibonacci_directions(n: int) -> np.ndarray:
    """n roughly-uniform unit directions (Fibonacci sphere)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1
    ).astype(np.float32)


@partial(jax.jit, static_argnames=("resolution", "num_directions", "trim"))
@matmul_highp
def convex_hull_volume(
    points: jax.Array,
    mask: jax.Array,
    resolution: int = 64,
    num_directions: int = 256,
    trim: int = 2,
) -> jax.Array:
    """Convex-hull volume of the masked points via support-function voxels.

    Args:
      points: (P, 3) cloud (padded slots allowed).
      mask: (P,) validity.
      resolution: voxel grid edge count R (R^3 cells over the tight AABB).
      num_directions: support directions D (more -> tighter hull).
      trim: use the (trim+1)-th largest projection as each direction's
        support — a raw max lets ANY surviving mis-triangulated point
        inflate the hull cubically, while discarding the top couple of
        points per direction costs a dense cloud only a sliver of surface.

    Returns:
      scalar volume (in world units^3).
    """
    dirs = jnp.asarray(_fibonacci_directions(num_directions))  # (D, 3)
    big = jnp.float32(1e9)
    pts = jnp.where(mask[:, None], points, jnp.nan)
    lo = jnp.nanmin(pts, axis=0)
    hi = jnp.nanmax(pts, axis=0)
    extent = jnp.maximum(hi - lo, 1e-6)

    # Support values: h(d) = trimmed max over valid points of <p, d> —
    # a (P, D) matmul followed by a per-direction top-k.
    proj = jnp.dot(points.astype(jnp.float32), dirs.T, precision=jax.lax.Precision.HIGHEST)
    proj = jnp.where(mask[:, None], proj, -big)
    k_eff = min(trim + 1, points.shape[0])
    topk, _ = jax.lax.top_k(proj.T, k_eff)  # (D, k)
    support = topk[:, k_eff - 1]  # (D,)

    # Voxel centers over the AABB.
    r = resolution
    axis = (jnp.arange(r, dtype=jnp.float32) + 0.5) / r
    gx = lo[0] + axis * extent[0]
    gy = lo[1] + axis * extent[1]
    gz = lo[2] + axis * extent[2]
    centers = jnp.stack(
        jnp.meshgrid(gx, gy, gz, indexing="ij"), axis=-1
    ).reshape(-1, 3)  # (R^3, 3)

    # Inside iff <v, d> <= h(d) for every sampled direction — (V, D) matmul.
    vproj = jnp.dot(centers, dirs.T, precision=jax.lax.Precision.HIGHEST)
    inside = jnp.all(vproj <= support[None, :] + 1e-6, axis=1)
    voxel_vol = jnp.prod(extent) / (r**3)
    return jnp.sum(inside) * voxel_vol


def maxpool_sep(g: jax.Array, r: int) -> jax.Array:
    """Binary dilation by a (2r+1)^2 square, run SEPARABLY (rows then
    columns): max over the rectangle with a constant out-of-bounds extension
    equals the composition of the two 1-D passes with the same extension,
    and the tap count drops from (2r+1)^2 to 2*(2r+1) — at the carve's
    closing radius (~13 grid cells) that is ~13x less VPU work per
    silhouette. The 2-D-equality identity is pinned by
    tests/test_volume_io.py::test_separable_morphology_matches_2d (on THESE
    functions — the carve calls them directly)."""
    g = jax.lax.reduce_window(
        g, jnp.float32(0.0), jax.lax.max, (1, 2 * r + 1), (1, 1), "SAME"
    )
    return jax.lax.reduce_window(
        g, jnp.float32(0.0), jax.lax.max, (2 * r + 1, 1), (1, 1), "SAME"
    )


def erode_sep(g: jax.Array, r: int) -> jax.Array:
    """Binary erosion by a (2r+1)^2 square, separable like ``maxpool_sep``.

    init -1 (not 0): reduce_window's init joins every window, and a 0 init
    would make max(-g) trivially 0 everywhere. (OOB is therefore treated as
    "set", so erosion never shrinks at the image border — the same contract
    in both 1-D passes.)"""
    g = -jax.lax.reduce_window(
        -g, jnp.float32(-1.0), jax.lax.max, (1, 2 * r + 1), (1, 1), "SAME"
    )
    return -jax.lax.reduce_window(
        -g, jnp.float32(-1.0), jax.lax.max, (2 * r + 1, 1), (1, 1), "SAME"
    )


@matmul_highp
def _carve_occupancy(
    points: jax.Array,
    mask: jax.Array,
    projections: jax.Array,
    proj_mask: jax.Array,
    image_size: Tuple[int, int],
    resolution: int,
    dilation: int,
    grid_step: int,
    close_frac: float,
    vote_frac: float,
):
    """Voxel-carving occupancy over the item AABB (shared carve core).

    Returns (inside (R^3,) bool, centers (R^3, 3), voxel_vol scalar).
    """
    w, h = image_size
    f = projections.shape[0]
    big = jnp.float32(1e9)

    pts = jnp.where(mask[:, None], points, jnp.nan)
    lo = jnp.nanmin(pts, axis=0)
    hi = jnp.nanmax(pts, axis=0)
    pad = 0.1 * jnp.maximum(hi - lo, 1e-6)
    lo = lo - pad
    extent = jnp.maximum(hi + pad - lo, 1e-6)

    homog = jnp.concatenate([points, jnp.ones_like(points[:, :1])], axis=1)  # (P, 4)

    # Low-res silhouette grids (W/grid_step x H/grid_step) keep memory tiny;
    # dilation scales. grid_step is in the projections' (working-res) pixel
    # units — callers processing downscaled keyframes shrink it to keep the
    # grid's FULL-res-equivalent granularity constant.
    gs = grid_step
    gw, gh = w // gs, h // gs
    rad = max(dilation // gs, 1)

    # Morphological closing radius: sparse feature points splat to isolated
    # dots, and plain dilation either leaves holes the carve then empties
    # (the item projects ~hundreds of px wide at 1080p) or, made large
    # enough to bridge them, inflates every silhouette boundary. Closing
    # (dilate THEN erode) bridges gaps up to twice this radius while
    # returning the outline to the points' envelope. RESOLUTION-RELATIVE:
    # ~3% of the long image side (56 px at 1080p); a fixed pixel radius
    # over-closes small images into blob silhouettes (measured 2-3x carve
    # overcount at 400x300) and under-closes at 4K.
    close_rad = max(round(close_frac * max(w, h)) // gs, 2 * rad)

    def silhouette(projmat):
        uvw = homog @ projmat.T  # (P, 3)
        uv = uvw[:, :2] / jnp.where(jnp.abs(uvw[:, 2:3]) > 1e-9, uvw[:, 2:3], 1.0)
        gx = jnp.clip((uv[:, 0] / gs).astype(jnp.int32), 0, gw - 1)
        gy = jnp.clip((uv[:, 1] / gs).astype(jnp.int32), 0, gh - 1)
        ok = mask & (uvw[:, 2] > 1e-6)
        grid = jnp.zeros((gh, gw), jnp.float32).at[
            jnp.where(ok, gy, gh), jnp.where(ok, gx, gw)
        ].set(1.0, mode="drop")

        closed = erode_sep(maxpool_sep(grid, close_rad), close_rad)
        # Final coverage slack around the closed silhouette.
        return maxpool_sep(closed, rad)

    sils = jax.vmap(silhouette)(projections)  # (F, gh, gw)

    r = resolution
    axis = (jnp.arange(r, dtype=jnp.float32) + 0.5) / r
    centers = jnp.stack(
        jnp.meshgrid(
            lo[0] + axis * extent[0],
            lo[1] + axis * extent[1],
            lo[2] + axis * extent[2],
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)
    vh = jnp.concatenate([centers, jnp.ones_like(centers[:, :1])], axis=1)  # (V, 4)

    def carve_view(projmat, sil, active):
        uvw = vh @ projmat.T
        z_ok = uvw[:, 2] > 1e-6
        uv = uvw[:, :2] / jnp.where(z_ok[:, None], uvw[:, 2:3], 1.0)
        gx = (uv[:, 0] / gs).astype(jnp.int32)
        gy = (uv[:, 1] / gs).astype(jnp.int32)
        in_img = z_ok & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
        val = sil[jnp.clip(gy, 0, gh - 1), jnp.clip(gx, 0, gw - 1)] > 0.5
        keep = in_img & val
        # Inactive views do not carve.
        return jnp.where(active, keep, True)

    keeps = jax.vmap(carve_view)(projections, sils, proj_mask)  # (F, V)
    # Vote, don't intersect: feature-splat silhouettes systematically
    # under-cover the item (texture-less boundaries carry no keypoints), and
    # a strict all-views intersection decays geometrically with view count.
    # Keeping voxels inside >= 80% of the active views tolerates per-view
    # coverage holes while still carving true free space (which nearly every
    # view agrees on).
    n_active = jnp.maximum(jnp.sum(proj_mask), 1)
    votes = jnp.sum(keeps & proj_mask[:, None], axis=0)
    inside = votes >= jnp.ceil(vote_frac * n_active).astype(votes.dtype)
    voxel_vol = jnp.prod(extent) / (r**3)
    return inside, centers, voxel_vol, sils


@matmul_highp
def _points_in_silhouettes(
    points, projections, proj_mask, sils, grid_step, vote_frac
):
    """(P,) mask: point projects inside >= vote_frac of the active views'
    silhouettes — visual-hull membership, evaluated per POINT with the same
    splat grids the voxel carve uses.

    The silhouettes are built from the carve's (gated) cloud, so this is a
    leave-the-suspects-out test: a mis-triangulated point smeared along one
    view's ray still projects near the item IN THAT VIEW, but its projection
    in the other views sweeps away from the gated cluster and loses the
    vote. True surface points — including ones the sigma/parallax gates
    wrongly reject — project inside every view's silhouette by construction.
    """
    gh, gw = sils.shape[1], sils.shape[2]
    homog = jnp.concatenate([points, jnp.ones_like(points[:, :1])], axis=1)

    def in_view(projmat, sil, active):
        uvw = homog @ projmat.T
        z_ok = uvw[:, 2] > 1e-6
        uv = uvw[:, :2] / jnp.where(z_ok[:, None], uvw[:, 2:3], 1.0)
        gx = (uv[:, 0] / grid_step).astype(jnp.int32)
        gy = (uv[:, 1] / grid_step).astype(jnp.int32)
        in_img = z_ok & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
        val = sil[jnp.clip(gy, 0, gh - 1), jnp.clip(gx, 0, gw - 1)] > 0.5
        return jnp.where(active, in_img & val, True)

    votes = jax.vmap(in_view)(projections, sils, proj_mask)  # (F, P)
    n_active = jnp.maximum(jnp.sum(proj_mask), 1)
    agree = jnp.sum(votes & proj_mask[:, None], axis=0)
    return agree >= jnp.ceil(vote_frac * n_active).astype(agree.dtype)


@partial(
    jax.jit,
    static_argnames=(
        "resolution", "dilation", "image_size", "grid_step", "close_frac",
        "vote_frac",
    ),
)
@matmul_highp
def carved_volume(
    points: jax.Array,
    mask: jax.Array,
    projections: jax.Array,
    proj_mask: jax.Array,
    image_size: Tuple[int, int],
    resolution: int = 64,
    dilation: int = 9,
    grid_step: int = 4,
    close_frac: float = 0.029,
    vote_frac: float = 0.8,
) -> jax.Array:
    """Voxel carving against splatted-and-dilated point silhouettes.

    Args:
      points: (P, 3) item points.
      mask: (P,) validity.
      projections: (F, 3, 4) per-keyframe projection matrices.
      proj_mask: (F,) which keyframes participate.
      image_size: (W, H) static.
      resolution: voxel grid edge count.
      dilation: silhouette dilation radius in pixels (coverage slack around
        sparse feature points).

    Returns:
      scalar carved volume.
    """
    inside, _, voxel_vol, _ = _carve_occupancy(
        points, mask, projections, proj_mask, image_size, resolution,
        dilation, grid_step, close_frac, vote_frac,
    )
    return jnp.sum(inside) * voxel_vol


@partial(
    jax.jit,
    static_argnames=(
        "resolution", "num_directions", "trim", "dilation", "image_size",
        "grid_step", "close_frac", "vote_frac", "trim_ref",
        "support_inflate",
    ),
)
@matmul_highp
def hull_and_carved_volume(
    points: jax.Array,
    mask: jax.Array,
    projections: jax.Array,
    proj_mask: jax.Array,
    image_size: Tuple[int, int],
    resolution: int = 64,
    num_directions: int = 512,
    trim: int = 7,
    dilation: int = 9,
    grid_step: int = 4,
    close_frac: float = 0.029,
    vote_frac: float = 0.8,
    support_mask: jax.Array | None = None,
    trim_ref: int = 0,
    support_inflate: float = 0.0,
) -> Tuple[jax.Array, jax.Array]:
    """Hull + carved volumes from ONE carve, in one XLA program.

    The hull is (robust symmetric completion of the item points) ∩ (carved
    visual hull). Why neither half suffices alone, measured on synthetic
    turntable scenes with exact ground-truth volume:

      * A feature cloud sees only the camera-facing side of the item, and
        surviving mis-triangulations push the raw point hull OVER while the
        unseen side pulls it UNDER — two large opposing errors whose partial
        cancellation is scene-dependent: +20% at the 400x300 test scene,
        +45% at the 1080p bench scene, +187..208% on variant ellipsoids.
      * Silhouette carving cannot bound the volume from a one-sided view
        wedge at all: with EXACT analytic silhouettes at the test scene's
        8 keyframe views the ideal visual hull is +132% over truth (the
        wedge's cone intersection never closes the unseen side).

    The estimator instead completes the unseen side by a central-symmetry
    prior and lets the silhouettes veto the completion wherever they DO
    constrain: reflect the seen surface through the carve-occupancy mean
    (a silhouette-constrained centre estimate, unbiased toward the seen
    side unlike the point centroid), take per-direction TRIMMED support
    values of the silhouette-PRUNED support cloud (see the pruning comment
    at the support step), and count voxels inside both that support body
    and the carve. The order-statistic trim (skip the ``trim`` deepest
    points per direction) steps past the residual tail of mis-triangulated
    survivors that inflate a raw max cubically. Accuracy is validated
    across a spread of synthetic scenes by ``tools/volume_validation.py``
    (after the split_item_points precision fix: with the
    gated support + trim=5 the shipped config spans -15..+11% across the
    non-flagged scenes — e2e -6.9%, flat item +11%, 80-degree arc -15.4%,
    1080p bench -14.3% — and an elongated item from a narrow 50-degree
    arc remains the known weak case at +~35%, surfaced to callers via
    ``ProcessResult.volume_confidence``; the symmetric completion cannot
    know the unseen long-axis extent). The symmetry prior is weaker
    than it sounds: overshoot in any direction the views constrain is
    carved away by the intersection, so it only fills the genuinely
    unobserved cone.

    ``volume_carved`` (the raw visual hull) keeps its classic upper-bound
    semantics for non-convex items; ``volume`` (this hull) is the best
    convex estimate. The hull can therefore legitimately be SMALLER than
    the carve — usually is, from a turntable wedge.

    Memory: the voxel support test is blocked over ``resolution`` slabs of
    R^2 voxels (lax.map), so the (V, D) projection matrix never
    materializes — at the default R=128, D=512 it would be 4.3 GB.

    Args:
      support_mask: optional wider point mask for the trimmed support step
        (default: ``mask``). The caller may gate ``mask`` hard for the
        carve's silhouettes (e.g. drop coarse-octave / low-parallax points)
        — but applying the same gates to the support points stacks two
        robustifiers and digs the trimmed support into the true surface
        (measured -20% at the e2e scene: the gates also reject true rim
        points). Give the support the full item cloud; the silhouette
        membership pruning + the trim are its robustness.

    Returns:
      (hull_volume, carved_volume) scalars, world units^3.
    """
    inside, centers, voxel_vol, sils = _carve_occupancy(
        points, mask, projections, proj_mask, image_size, resolution,
        dilation, grid_step, close_frac, vote_frac,
    )
    carve_vol = jnp.sum(inside) * voxel_vol

    big = jnp.float32(1e9)
    dirs = jnp.asarray(_fibonacci_directions(num_directions))  # (D, 3)

    # Reflection centre: occupancy mean of the carve (falls back to the
    # masked point mean when the carve is empty — degenerate reconstruction).
    w = inside.astype(jnp.float32)
    nw = jnp.sum(w)
    pts_f = points.astype(jnp.float32)
    n_mask = jnp.maximum(jnp.sum(mask), 1)
    pt_mean = jnp.sum(jnp.where(mask[:, None], pts_f, 0.0), axis=0) / n_mask
    occ_mean = jnp.where(
        nw > 0, jnp.sum(centers * w[:, None], axis=0) / jnp.maximum(nw, 1.0), pt_mean
    )

    # Support cloud: the (possibly wider) support_mask PRUNED BY VISUAL-HULL
    # MEMBERSHIP — a support point must project inside >= vote_frac of the
    # active silhouettes (built from the carve's `mask` cloud). This is the
    # estimator's outlier model: surviving mis-triangulations smear along
    # single-view rays, so they hold their own view's silhouette but lose
    # the vote everywhere else, while true surface points (even ones the
    # sigma/parallax gates reject) pass every view. Without it, one deep
    # smear drags inf_seen down and the symmetric reflection balloons into
    # the unseen cone where the carve cannot veto (measured +17.7% at the
    # 1080p bench scene); with it, the order-statistic trim only has pixel
    # noise left to absorb (see tools/volume_validation.py for the table).
    smask = mask if support_mask is None else support_mask
    smask = smask & _points_in_silhouettes(
        points, projections, proj_mask, sils, grid_step, vote_frac
    )
    pproj = jnp.dot(pts_f, dirs.T, precision=jax.lax.Precision.HIGHEST)
    k_eff = min(trim + 1, points.shape[0])
    top_hi, _ = jax.lax.top_k(jnp.where(smask[:, None], pproj, -big).T, k_eff)
    top_lo, _ = jax.lax.top_k(jnp.where(smask[:, None], -pproj, -big).T, k_eff)
    # Sparse-aware trim depth: the order statistic digs a
    # FIXED number of points past each direction's extreme, so its bite is
    # proportionally deeper the sparser the support cloud — measured: the
    # trim=5 depth tuned on the ~1800-point bench cloud underread ~300-point
    # short-clip clouds by 55-71% (each trimmed point is a visible slab of a
    # sparse shell, a sliver of a dense one). With ``trim_ref`` > 0 the
    # depth scales linearly with the support count, reaching the configured
    # ``trim`` at ``trim_ref`` points and 0 (raw max — the silhouette-
    # membership pruning above is then the sole outlier guard) for very
    # sparse clouds; ``trim_ref=0`` keeps the fixed depth (compat).
    if trim_ref > 0:
        n_sup = jnp.sum(smask)
        depth = jnp.clip((n_sup * trim) // trim_ref, 0, k_eff - 1)
    else:
        depth = k_eff - 1
    sup_seen = jnp.take(top_hi, depth, axis=1)  # (D,)
    inf_seen = -jnp.take(top_lo, depth, axis=1)  # (D,) trimmed min
    # Reflected seen surface: reflect p -> 2c - p flips the support function,
    # sup_refl(d) = 2<c, d> - inf_seen(d).
    sup_refl = 2.0 * jnp.dot(occ_mean, dirs.T) - inf_seen
    support = jnp.maximum(sup_seen, sup_refl)
    if support_inflate > 0:
        # Sampling-interval inflation: feature points sit ON TEXTURE, never
        # on the item's smooth occluding limb, so the support cloud samples
        # a shell that is systematically INSIDE the true surface by about
        # one surface sampling interval — a bias that grows as the cloud
        # thins (measured: -14% on the ~1800-point bench cloud, -20..-31%
        # on ~800-point short-clip clouds). Estimate the interval as the
        # median 6th-NN distance of the support cloud and push every
        # support plane out by `support_inflate` of it; the carve
        # intersection still vetoes the inflation wherever the silhouettes
        # actually constrain the surface.
        big2 = jnp.float32(1e9)
        sqn = jnp.sum(pts_f * pts_f, axis=1)
        d2 = sqn[:, None] + sqn[None, :] - 2.0 * jnp.dot(
            pts_f, pts_f.T, precision=jax.lax.Precision.HIGHEST
        )
        d2 = jnp.where(smask[None, :], d2, big2)
        d2 = d2 + jnp.where(
            jnp.eye(pts_f.shape[0], dtype=bool), big2, 0.0
        )
        k_nn = min(6, pts_f.shape[0])
        neg_top, _ = jax.lax.top_k(-d2, k_nn)
        dk = jnp.sqrt(jnp.maximum(-neg_top[:, -1], 0.0))
        dk_med = jnp.nan_to_num(
            jnp.nanmedian(jnp.where(smask, dk, jnp.nan)), nan=0.0
        )
        support = support + support_inflate * dk_med

    # Count voxels inside BOTH the support body and the carve, blocked over
    # R slabs so the (V, D) projection never materializes.
    r = resolution
    cblocks = centers.reshape(r, r * r, 3)
    iblocks = inside.reshape(r, r * r)

    def slab_count(slab):
        cb, ib = slab
        vp = jnp.dot(cb, dirs.T, precision=jax.lax.Precision.HIGHEST)
        in_sym = jnp.all(vp <= support[None, :] + 1e-6, axis=1)
        return jnp.sum(in_sym & ib)

    counts = jax.lax.map(slab_count, (cblocks, iblocks))
    hull_vol = jnp.sum(counts) * voxel_vol
    return hull_vol, carve_vol
