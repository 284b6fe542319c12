"""ORB: FAST corners + orientation + rotated-BRIEF descriptors, on device.

Replacement for ``cv2.ORB_create(nfeatures=20000)`` /
``detectAndCompute`` (``processor.py:308, 129, 328``). Everything is
static-shaped (fixed keypoint capacity per level, validity masks) per
SURVEY.md §7.1.

Pipeline per pyramid level (scale 1.2, like ORB):
  1. FAST-9/16 segment test, fully vectorized: the 16 Bresenham-ring
     neighbours come from ``jnp.roll``-style shifts; the "9 contiguous"
     predicate is a windowed sum over the doubled ring.
  2. Harris cornerness ranking (ORB's HARRIS_SCORE default) + 3x3 NMS +
     static top-k.
  3. Orientation by intensity centroid over the masked 31x31 patch
     (gathered per keypoint, ``vmap``).
  4. rBRIEF: 256 coordinate pairs rotated by the keypoint angle, bilinearly
     sampled from the 7x7-Gaussian-blurred image, compared into a (256,)
     bit vector stored as int8 — the layout the Hamming-matmul matcher
     (``ops/matching.py``) consumes directly.

Deviation, by design (SURVEY.md §7.3.2): the sampling pattern is a fixed
seeded Gaussian pattern (the original BRIEF construction), not OpenCV's
learned table — descriptors are self-consistent within this framework, and
parity is held downstream (matches -> poses -> RMSE), not bit-for-bit.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meatmodeler_tpu.ops import features as feat

__all__ = ["OrbFeatures", "fast_score", "detect_and_compute", "brief_bin_weights"]

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
# (dy, dx) offsets — the standard FAST ring geometry.
_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

_PATCH = 31  # description patch (ORB's PATCH_SIZE)
_HALF = _PATCH // 2
_NBITS = 256


def _make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) int32 sample-pair offsets, Gaussian sigma = patch/5,
    clipped inside the patch (BRIEF's G(0, S^2/25) construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=_PATCH / 5.0, size=(_NBITS, 2, 2))
    return np.clip(np.round(pts), -_HALF + 2, _HALF - 2).astype(np.float32)


class OrbFeatures(NamedTuple):
    xy: jax.Array  # (K, 2) float32 (x, y) at level-0 scale
    response: jax.Array  # (K,) Harris score
    angle: jax.Array  # (K,) orientation in radians
    octave: jax.Array  # (K,) int32 pyramid level
    descriptors: jax.Array  # (K, 256) int8 bits in {0, 1}
    mask: jax.Array  # (K,) bool


def _ring_stack(img: jax.Array) -> jax.Array:
    """(16, H, W): the ring neighbours of every pixel (edge-padded shifts)."""
    padded = jnp.pad(img, 3, mode="edge")
    h, w = img.shape
    return jnp.stack(
        [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _RING]
    )


def fast_score(img: jax.Array, threshold: float = 20.0) -> jax.Array:
    """FAST-9/16 corner mask (as float 0/1) — the segment test.

    A pixel passes if >= 9 contiguous ring neighbours are all brighter than
    p + t or all darker than p - t.
    """
    ring = _ring_stack(img)  # (16, H, W)
    brighter = (ring > img[None] + threshold).astype(jnp.float32)
    darker = (ring < img[None] - threshold).astype(jnp.float32)

    def has_arc(flags):
        doubled = jnp.concatenate([flags, flags[:7]], axis=0)  # (23, H, W)
        csum = jnp.cumsum(doubled, axis=0)
        csum = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)
        window = csum[9:] - csum[:-9]  # (15... actually 23-9+1=15, H, W)
        return jnp.max(window, axis=0) >= 9.0

    return (has_arc(brighter) | has_arc(darker)).astype(img.dtype)


def _orientation(img: jax.Array, xy: jax.Array, mask: jax.Array) -> jax.Array:
    """Intensity-centroid orientation over the circular 31x31 patch."""
    dy = jnp.arange(-_HALF, _HALF + 1, dtype=img.dtype)
    dx = jnp.arange(-_HALF, _HALF + 1, dtype=img.dtype)
    circ = (dy[:, None] ** 2 + dx[None, :] ** 2) <= _HALF**2

    h, w = img.shape

    def one(pt, valid):
        x0 = jnp.clip(pt[0].astype(jnp.int32) - _HALF, 0, w - _PATCH)
        y0 = jnp.clip(pt[1].astype(jnp.int32) - _HALF, 0, h - _PATCH)
        patch = jax.lax.dynamic_slice(img, (y0, x0), (_PATCH, _PATCH)) * circ
        m01 = jnp.sum(patch * dy[:, None])
        m10 = jnp.sum(patch * dx[None, :])
        return jnp.where(valid, jnp.arctan2(m01, m10), 0.0)

    return jax.vmap(one)(xy, mask)


# Steered BRIEF as matmuls: the angle is quantized to 30 bins (ORB uses 12
# degree bins) and each bin's 512 bilinear sampling taps over a DPATCH x
# DPATCH patch are baked into a dense weight matrix. Descriptor sampling for
# ALL keypoints is then one (30*512, DPATCH^2) x (DPATCH^2, N) matmul + a
# per-keypoint bin selection — zero scattered gathers.
_NBINS = 30
_DPATCH = 41  # covers the +-13 pattern offsets under any rotation (+1 bilinear)
_DHALF = _DPATCH // 2


def _make_bin_weights() -> np.ndarray:
    """(NBINS * 512, DPATCH^2) float32 bilinear sampling weights.

    Row layout: bin-major; within a bin, rows 0..255 are pair endpoint A,
    rows 256..511 endpoint B.
    """
    pat = _make_brief_pattern()  # (256, 2, (dy, dx))
    w = np.zeros((_NBINS, 512, _DPATCH * _DPATCH), np.float32)
    for b in range(_NBINS):
        ang = 2.0 * np.pi * b / _NBINS
        c, s = np.cos(ang), np.sin(ang)
        dy = pat[..., 0]  # (256, 2)
        dx = pat[..., 1]
        rx = c * dx - s * dy + _DHALF
        ry = s * dx + c * dy + _DHALF
        x0 = np.clip(np.floor(rx).astype(int), 0, _DPATCH - 2)
        y0 = np.clip(np.floor(ry).astype(int), 0, _DPATCH - 2)
        fx = rx - x0
        fy = ry - y0
        for e in range(2):  # endpoint
            rows = np.arange(256) + 256 * e
            flat00 = y0[:, e] * _DPATCH + x0[:, e]
            w[b, rows, flat00] += (1 - fy[:, e]) * (1 - fx[:, e])
            w[b, rows, flat00 + 1] += (1 - fy[:, e]) * fx[:, e]
            w[b, rows, flat00 + _DPATCH] += fy[:, e] * (1 - fx[:, e])
            w[b, rows, flat00 + _DPATCH + 1] += fy[:, e] * fx[:, e]
    return w.reshape(_NBINS * 512, _DPATCH * _DPATCH)


_BIN_WEIGHTS_NP = _make_bin_weights()  # host-side; see brief_bin_weights()


@functools.lru_cache(maxsize=1)
def brief_bin_weights() -> jax.Array:
    """The (30*512, DPATCH^2) sampling-weight matrix as a DEVICE array.

    Always thread this through jit boundaries as a real argument (see
    ``detect_and_compute``'s ``bin_weights``): closing over it inside a
    traced function embeds all 52 MB as an HLO literal, which makes
    lowering and compiling each pyramid level's program far slower.
    """
    return jnp.asarray(_BIN_WEIGHTS_NP, jnp.bfloat16)


def _describe(
    blurred: jax.Array,
    xy: jax.Array,
    angle: jax.Array,
    mask: jax.Array,
    bin_weights: jax.Array,
) -> jax.Array:
    """Steered BRIEF bits via the binned sampling matmul."""
    n = xy.shape[0]
    padded = jnp.pad(blurred, _DHALF + 1, mode="edge")
    h, w = blurred.shape

    def patch(pt):
        x0 = jnp.clip(pt[0].astype(jnp.int32), 0, w - 1) + 1  # +pad offset - half
        y0 = jnp.clip(pt[1].astype(jnp.int32), 0, h - 1) + 1
        return jax.lax.dynamic_slice(padded, (y0, x0), (_DPATCH, _DPATCH))

    patches = jax.vmap(patch)(xy).reshape(n, _DPATCH * _DPATCH)  # (N, P2)

    # (30*512, P2) @ (P2, N) -> (30*512, N): one matmul for everything.
    sampled = jax.lax.dot_general(
        bin_weights.astype(jnp.bfloat16),
        patches.astype(jnp.bfloat16).T,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(_NBINS, 512, n)

    # Per-keypoint bin selection (angle quantized like ORB's 12-degree bins).
    # Unrolled masked sum instead of a degenerate 30-wide einsum
    # contraction.
    bin_idx = jnp.round(angle / (2.0 * jnp.pi / _NBINS)).astype(jnp.int32) % _NBINS
    vals = sum(
        sampled[b] * (bin_idx == b).astype(jnp.float32)[None, :]
        for b in range(_NBINS)
    ).T  # (N, 512)

    bits = (vals[:, :256] < vals[:, 256:]).astype(jnp.int8)
    return jnp.where(mask[:, None], bits, jnp.zeros((n, _NBITS), jnp.int8))


def _gauss7(img: jax.Array) -> jax.Array:
    """7x7 Gaussian (sigma 2) blur, separable — ORB's pre-BRIEF smoothing."""
    g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    g /= g.sum()
    g = jnp.asarray(g, img.dtype)
    p = jnp.pad(img, ((3, 3), (0, 0)), mode="edge")
    tmp = sum(g[i] * p[i : i + img.shape[0]] for i in range(7))
    p = jnp.pad(tmp, ((0, 0), (3, 3)), mode="edge")
    return sum(g[i] * p[:, i : i + img.shape[1]] for i in range(7))


def detect_and_compute(
    img: jax.Array,
    max_features: int = 4096,
    num_levels: int = 4,
    scale_factor: float = 1.2,
    fast_threshold: float = 20.0,
    bin_weights: jax.Array | None = None,
    topk_recall: float = 0.95,
    grid_cells: int = 0,
) -> OrbFeatures:
    """Oriented-FAST detection + rBRIEF description over a scale pyramid.

    Args:
      img: (H, W) grey image in [0, 255].
      max_features: static total keypoint capacity (reference runs 20000,
        ``processor.py:308``).
      num_levels: pyramid levels, scale 1.2 (ORB defaults 8; 4 covers the
        turntable videos and halves the work).
      fast_threshold: FAST intensity threshold.
      bin_weights: the ``brief_bin_weights()`` matrix. Callers wrapping this
        function in their OWN ``jax.jit`` must obtain it outside the trace
        and thread it through as an argument — leaving it None inside a
        trace silently embeds the 52 MB matrix as an HLO constant and costs
        minutes of compile time (see ``brief_bin_weights``).
      grid_cells: spatially-bucketed selection: divide each level into a
        G x G cell grid and cap every cell at ceil(budget / G^2) keypoints
        before the global ranking (cv2's ORB spreads keypoints with a
        quadtree for the same reason). 0 = pure global ranking. With global
        ranking, weak-texture regions lose every slot to the strongest
        object corners; their keypoints flicker in and out of the top-k
        between keyframes, killing multi-view track survival exactly where
        the marker-free chain needs background parallax (measured on the
        ground-textured marker-free scene: three-view track support ~50 of
        212 pair matches).

    Returns:
      OrbFeatures with per-keypoint position (level-0 pixels), response,
      angle, octave, (256,) int8 bit descriptor, and validity mask.
    """
    if bin_weights is None:
        bin_weights = brief_bin_weights()
    return _detect_and_compute(
        img,
        bin_weights,
        max_features=max_features,
        num_levels=num_levels,
        scale_factor=scale_factor,
        fast_threshold=fast_threshold,
        topk_recall=topk_recall,
        grid_cells=grid_cells,
    )


@partial(
    jax.jit,
    static_argnames=(
        "max_features", "num_levels", "scale_factor", "fast_threshold",
        "topk_recall", "grid_cells",
    ),
)
def _detect_and_compute(
    img: jax.Array,
    bin_weights: jax.Array,
    max_features: int,
    num_levels: int,
    scale_factor: float,
    fast_threshold: float,
    topk_recall: float,
    grid_cells: int = 0,
) -> OrbFeatures:
    img = jnp.asarray(img)
    # Geometric per-level budget, like ORB's feature distribution.
    inv_total = (1.0 - 1.0 / scale_factor) / (1.0 - (1.0 / scale_factor) ** num_levels)
    budgets = []
    rem = max_features
    for lvl in range(num_levels):
        if lvl == num_levels - 1:
            budgets.append(rem)
        else:
            b = int(round(max_features * inv_total * (1.0 / scale_factor) ** lvl))
            b = min(b, rem)
            budgets.append(b)
            rem -= b

    level_img = img
    outs = []
    for lvl in range(num_levels):
        k = max(budgets[lvl], 1)
        h, w = level_img.shape
        corner_mask = fast_score(level_img, fast_threshold)
        harris = feat.harris_response(level_img, block_size=7)
        resp = jnp.where(corner_mask > 0, harris, -jnp.inf)

        # 3x3 NMS + border margin.
        neigh = jax.lax.reduce_window(resp, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        margin = _HALF + 1
        ok = (
            (resp >= neigh)
            & (yy >= margin) & (yy < h - margin)
            & (xx >= margin) & (xx < w - margin)
        )
        masked = jnp.where(ok, resp, -jnp.inf)
        # Small images (deep pyramid levels, warmup probes) can have fewer
        # pixels than the level's feature budget; top-k requires k <= n, so
        # select what exists and pad the static capacity with masked slots.
        k_eff = min(k, h * w)
        # approx_max_k: approximate top-k. Corner selection tolerates
        # approximation: a missed corner is just a marginally weaker
        # keypoint set, and capacity k usually exceeds the number of true
        # corners anyway. On the GPU it lowers to an exact sort (ROADMAP
        # 3.3); topk_recall=1.0 forces exact top_k.
        if grid_cells > 1 and h >= grid_cells and w >= grid_cells:
            # Bucketed selection: rank within G x G cells first (cap
            # ceil(k/G^2) per cell), then rank the cell survivors globally.
            # Every cell keeps its best local corners regardless of how they
            # compare to the globally strongest region, so weak-texture
            # areas hold stable top-k membership across keyframes. Static
            # shapes throughout: (G^2, cell_px) batched top-k, then one
            # (G^2 * k_cell,) global top-k.
            g = grid_cells
            ph, pw = -h % g, -w % g
            padded = jnp.pad(
                masked, ((0, ph), (0, pw)), constant_values=-jnp.inf
            )
            hh, ww = h + ph, w + pw
            ch, cw = hh // g, ww // g
            cells = (
                padded.reshape(g, ch, g, cw).transpose(0, 2, 1, 3)
                .reshape(g * g, ch * cw)
            )
            k_cell = min(-(-k // (g * g)), ch * cw)
            if topk_recall >= 1.0:
                c_resp, c_idx = jax.lax.top_k(cells, k_cell)
            else:
                c_resp, c_idx = jax.lax.approx_max_k(
                    cells, k_cell, recall_target=topk_recall
                )
                c_idx = c_idx.astype(jnp.int32)
            ci = jnp.arange(g * g, dtype=jnp.int32)
            cy = (ci // g)[:, None] * ch + c_idx // cw
            cx = (ci % g)[:, None] * cw + c_idx % cw
            cand_resp = c_resp.reshape(-1)
            # Padded-strip candidates carry -inf response (masked
            # downstream); clamp their (y, x) into the true image so the
            # patch gathers they still feed stay in bounds.
            cand_idx = (
                jnp.minimum(cy, h - 1) * w + jnp.minimum(cx, w - 1)
            ).reshape(-1)
            k_eff = min(k_eff, cand_resp.shape[0])
            top_resp, sel = jax.lax.top_k(cand_resp, k_eff)
            top_idx = cand_idx[sel]
        else:
            flat = masked.reshape(-1)
            if topk_recall >= 1.0:
                top_resp, top_idx = jax.lax.top_k(flat, k_eff)
            else:
                top_resp, top_idx = jax.lax.approx_max_k(
                    flat, k_eff, recall_target=topk_recall
                )
                top_idx = top_idx.astype(jnp.int32)
        if k_eff < k:
            top_resp = jnp.pad(top_resp, (0, k - k_eff), constant_values=-jnp.inf)
            top_idx = jnp.pad(top_idx, (0, k - k_eff))
        kxy = jnp.stack(
            [(top_idx % w).astype(jnp.float32), (top_idx // w).astype(jnp.float32)],
            axis=-1,
        )
        kmask = jnp.isfinite(top_resp)

        angle = _orientation(level_img, kxy, kmask)
        blurred = _gauss7(level_img)
        desc = _describe(blurred, kxy, angle, kmask, bin_weights)

        lvl_scale = scale_factor**lvl
        outs.append(
            OrbFeatures(
                xy=kxy * lvl_scale,
                response=jnp.where(kmask, top_resp, -jnp.inf).astype(jnp.float32),
                angle=angle.astype(jnp.float32),
                octave=jnp.full(k, lvl, jnp.int32),
                descriptors=desc,
                mask=kmask,
            )
        )

        if lvl < num_levels - 1:
            # Resize to the next level (bilinear 1/1.2 downscale).
            nh = max(int(round(h / scale_factor)), _PATCH + 2)
            nw = max(int(round(w / scale_factor)), _PATCH + 2)
            level_img = jax.image.resize(level_img, (nh, nw), "linear")

    return OrbFeatures(
        xy=jnp.concatenate([o.xy for o in outs]),
        response=jnp.concatenate([o.response for o in outs]),
        angle=jnp.concatenate([o.angle for o in outs]),
        octave=jnp.concatenate([o.octave for o in outs]),
        descriptors=jnp.concatenate([o.descriptors for o in outs]),
        mask=jnp.concatenate([o.mask for o in outs]),
    )
