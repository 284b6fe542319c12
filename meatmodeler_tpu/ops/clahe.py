"""CLAHE — contrast-limited adaptive histogram equalization, on device.

Replacement for ``cv2.createCLAHE(clipLimit=3.5,
tileGridSize=(8, 8)).apply`` (``processor.py:22-23``), the per-frame
preprocessing of every video frame (HOT LOOP #1, SURVEY.md §3.1).

Algorithm (mirrors OpenCV's):
  1. pad the image with reflected borders so it divides into the tile grid;
  2. per-tile 256-bin histogram;
  3. clip each histogram at ``clipLimit * tile_area / 256`` and redistribute
     the excess uniformly across bins;
  4. cumulative sum -> per-tile LUT scaled to [0, 255];
  5. each output pixel bilinearly interpolates the LUTs of its 4 surrounding
     tile centers.

Everything is one XLA program over (..., H, W) batches, on every backend:
histograms via scatter-add, the LUT application as band-wise one-hot
matmuls (see ``_clahe_single``), ``vmap``-ed over a frame batch. Held to statistical parity with OpenCV
(SURVEY.md §7.3.4: interpolation details are unspecified; tolerance is
mean-abs-difference of a couple of grey levels, not bitwise).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["clahe"]


def _pad_to_tiles(img: jax.Array, tiles: Tuple[int, int]):
    h, w = img.shape[-2], img.shape[-1]
    ty, tx = tiles
    th = -(-h // ty)  # ceil
    tw = -(-w // tx)
    pad_y = th * ty - h
    pad_x = tw * tx - w
    pad_cfg = [(0, 0)] * (img.ndim - 2) + [(0, pad_y), (0, pad_x)]
    return jnp.pad(img, pad_cfg, mode="reflect"), (th, tw)


@partial(jax.jit, static_argnames=("tiles",))
def clahe(
    img: jax.Array, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)
) -> jax.Array:
    """Apply CLAHE to a single-channel image (or batch).

    Args:
      img: (..., H, W) image with values in [0, 255] (any float/int dtype).
      clip_limit: OpenCV-style relative clip limit.
      tiles: (rows, cols) tile grid.

    Returns:
      (..., H, W) float32 equalized image in [0, 255].
    """
    img = jnp.asarray(img)
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape((-1, h, w))

    out = jax.vmap(lambda im: _clahe_single(im, clip_limit, tiles))(flat)
    return out.reshape(*batch_shape, h, w)


def _clahe_single(img: jax.Array, clip_limit: float, tiles: Tuple[int, int]) -> jax.Array:
    h, w = img.shape
    ty, tx = tiles
    padded, (th, tw) = _pad_to_tiles(img, tiles)

    # Round, don't truncate: upstream stages hand in float intensities (e.g.
    # the LAB L channel) and OpenCV's equivalent path sees them rounded to
    # uint8.
    vals = jnp.round(jnp.clip(padded, 0.0, 255.0)).astype(jnp.int32)

    # --- per-tile histograms via one flat scatter-add ---
    tile_row = jnp.arange(th * ty) // th
    tile_col = jnp.arange(tw * tx) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]  # (Hp, Wp)
    flat_bin = (tile_id * 256 + vals).reshape(-1)
    hist = jnp.zeros((ty * tx * 256,), jnp.float32).at[flat_bin].add(1.0)
    hist = hist.reshape(ty * tx, 256)

    # --- clip + redistribution, mirroring OpenCV's integer arithmetic:
    # clip = max(1, int(clipLimit * area / 256)); excess spread as
    # floor(excess/256) per bin plus one unit into every
    # max(256//residual, 1)-th bin until the residual runs out. The integer
    # truncation matters: for small tiles it shifts the clip by tens of
    # percent (e.g. 2.625 -> 2) and with it the whole contrast curve.
    area = float(th * tw)
    clip = jnp.maximum(1.0, jnp.floor(clip_limit * area / 256.0))
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip)
    redist = jnp.floor(excess / 256.0)
    residual = excess - redist * 256.0  # (T, 1) in [0, 256)
    step = jnp.maximum(jnp.floor(256.0 / jnp.maximum(residual, 1.0)), 1.0)
    bins = jnp.arange(256.0)[None, :]
    bonus = ((bins % step == 0) & (bins / step < residual)).astype(hist.dtype)
    hist = hist + redist + bonus

    # --- CDF -> LUT in [0, 255] ---
    cdf = jnp.cumsum(hist, axis=1)
    lut = jnp.clip(jnp.round(cdf * (255.0 / area)), 0.0, 255.0)  # (T, 256)
    lut = lut.reshape(ty, tx, 256)

    # --- bilinear interpolation between the 4 surrounding tile LUTs ---
    # Gather-free: the image splits into (ty+1) x (tx+1) static bands
    # between tile centers; within a band the 4 source tiles are FIXED, so
    # the lookup becomes a one-hot(pixel) @ lut4 matmul. (Whether a plain
    # per-pixel gather is faster on the GPU is unmeasured; see ROADMAP.)
    pix = vals[:h, :w].astype(jnp.bfloat16)  # 0..255 exact in bf16
    bins = jnp.arange(256, dtype=jnp.bfloat16)

    # Split rows into bands between vertical tile centers: within a band the
    # two contributing tile ROWS are fixed, so the lookup over that band is
    # ONE (band_pixels, 256) x (256, 2*tx) matmul; the horizontal tile
    # interpolation is a separable einsum with per-column weights.
    def band_bounds(n_tiles, tile_px, total):
        centers = [int(np.ceil((i + 0.5) * tile_px)) for i in range(n_tiles)]
        bounds = [0] + [min(c, total) for c in centers] + [total]
        out = [bounds[0]]
        for b in bounds[1:]:
            out.append(max(b, out[-1]))
        return out

    yb = band_bounds(ty, th, h)
    fy = jnp.arange(h, dtype=jnp.float32) / th - 0.5
    fx = jnp.arange(w, dtype=jnp.float32) / tw - 0.5
    # Horizontal interpolation weights to each tile column: (W, tx).
    j_ids = jnp.arange(tx, dtype=jnp.float32)
    wx_all = jnp.clip(1.0 - jnp.abs(fx[:, None] - j_ids[None, :]), 0.0, 1.0)
    # Border columns absorb the out-of-range weight (clamped tiles).
    wx_all = wx_all.at[:, 0].add(jnp.clip(-fx, 0.0, 1.0))
    wx_all = wx_all.at[:, tx - 1].add(jnp.clip(fx - (tx - 1), 0.0, 1.0))

    lut_rows = lut.reshape(ty, tx, 256)

    out_bands = []
    for bi in range(len(yb) - 1):
        ys0, ys1 = yb[bi], yb[bi + 1]
        if ys0 >= ys1:
            continue
        i0 = 0 if bi == 0 else min(bi - 1, ty - 1)
        i1 = min(i0 + 1, ty - 1) if bi > 0 else 0
        band = pix[ys0:ys1]  # (bh, W)
        onehot = (band[:, :, None] == bins).astype(jnp.bfloat16)  # (bh, W, 256)
        lut_pair = jnp.concatenate(
            [lut_rows[i0], lut_rows[i1]], axis=0
        ).astype(jnp.bfloat16)  # (2*tx, 256)
        v = jax.lax.dot_general(
            onehot.reshape(-1, 256),
            lut_pair,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(ys1 - ys0, w, 2, tx)
        wy = jnp.clip(fy[ys0:ys1] - i0, 0.0, 1.0) if bi > 0 else jnp.zeros(ys1 - ys0)
        wy_pair = jnp.stack([1.0 - wy, wy], axis=-1)  # (bh, 2)
        out_bands.append(jnp.einsum("hwij,hi,wj->hw", v, wy_pair, wx_all))
    return jnp.concatenate(out_bands, axis=0)


def enhance_contrast_bgr(bgr: jax.Array, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> jax.Array:
    """The reference's ``increaseContrast`` (``processor.py:12-26``): CLAHE on
    the L channel of LAB, back to BGR. Batched over leading dims."""
    from meatmodeler_tpu.ops import color

    lab = color.bgr_to_lab(bgr)
    l_eq = clahe(lab[..., 0], clip_limit=clip_limit, tiles=tiles)
    lab_eq = jnp.concatenate([l_eq[..., None], lab[..., 1:]], axis=-1)
    return color.lab_to_bgr(lab_eq)


def enhanced_grey(bgr: jax.Array, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> jax.Array:
    """Fused ``increaseContrast`` + BGR->grey — the exact per-frame preprocess
    of the reference's hot loop (``processor.py:357``), one XLA program."""
    from meatmodeler_tpu.ops import color

    return color.bgr_to_grey(enhance_contrast_bgr(bgr, clip_limit, tiles))
