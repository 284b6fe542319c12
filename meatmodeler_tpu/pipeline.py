"""End-to-end SfM + volume pipeline — the ``process`` entry point.

Mirrors the reference's only public entry point
``process(video, path, lk_params, feature_params, flann_params)``
(``processor.py:294-489``) but inverts the architecture for an
accelerator (SURVEY.md §7.1): instead of a per-frame Python loop ping-ponging into OpenCV, the work
runs in two device passes plus one batched geometry phase:

  PASS 1 (keyframe selection): frames stream to device in chunks; a
    ``lax.scan`` carries the KLT state (pyramid, tracked points, accumulated
    error) across frames and emits a keyframe flag per frame — the logic of
    ``keyframeTracking`` (``processor.py:61-110``) including the NaN/negative
    error clamps (``:95-97``) and the ``err > threshold * width`` rule
    (``:100``).
  PASS 2 (keyframe batch): accepted keyframes (those with a visible
    chessboard, host-detected like ``processor.py:369-371``) are processed
    *all at once*: ORB detect+describe vmapped over keyframes, consecutive-
    pair matching as batched Hamming matmuls, SoA track-store updates.
  GEOMETRY: corner subpix refine (batched) -> Zhang calibration ->
    undistort -> planar PnP (batched) -> pose-only BA -> widest-baseline
    triangulation (batched DLT) -> full Schur BA -> volume -> PLY.

``process`` returns the cloud, poses, intrinsics, volume, and metrics —
fixing the reference's broken promise of a return value
(``processor.py:303`` documents one; the code returns None).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meatmodeler_tpu.utils import compile_cache

compile_cache.configure()

from meatmodeler_tpu import tracks as tracks_mod
from meatmodeler_tpu import volume as volume_mod
from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig, SolverConfig
from meatmodeler_tpu.geometry import calibration, distortion, pnp, projection, so3, triangulation
from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu.io import ply as ply_mod
from meatmodeler_tpu.io import video as video_mod
from meatmodeler_tpu.ops import board_detect, chessboard, clahe, features, klt, matching, orb
from meatmodeler_tpu.solvers import bundle_adjust
from meatmodeler_tpu.utils import Metrics
from meatmodeler_tpu.utils import numerics
from meatmodeler_tpu.utils.precision import matmul_highp
from meatmodeler_tpu.utils.profiling import logger

__all__ = ["ProcessResult", "process"]


class ProcessResult(NamedTuple):
    points: np.ndarray  # (P, 3) bundle-adjusted cloud
    extrinsics: np.ndarray  # (F, 4, 4) refined keyframe extrinsics
    intrinsics: np.ndarray  # (3, 3)
    distortion: np.ndarray  # (5,)
    volume: float  # convex-hull volume of the item
    volume_carved: float  # voxel-carved volume
    ply_path: Optional[str]
    reprojection_rmse: float
    metrics: Dict[str, Any]
    # Volume-estimate regime check: {"low_confidence", "view_arc_deg",
    # "elongation", "reason", "n_item_points"}. low_confidence=True means the
    # (view arc, item elongation) pair sits in the estimator's validated
    # weak regime (narrow arc x elongated item: ~+40% hull overshoot — see
    # VolumeConfig.confidence_* and tools/volume_validation.py).
    volume_confidence: Optional[Dict[str, Any]] = None


def _config_from_param_dicts(config, lk_params, feature_params):
    """Fold the reference's cv2 param dicts (``processor.py:294-301``) into
    the config tree for API compatibility."""
    kf = config.keyframe
    if lk_params:
        if "winSize" in lk_params:
            kf = dataclasses.replace(kf, window=int(lk_params["winSize"][0]))
        if "maxLevel" in lk_params:
            kf = dataclasses.replace(kf, pyramid_levels=int(lk_params["maxLevel"]) + 1)
        if "criteria" in lk_params:
            _, iters, eps = lk_params["criteria"]
            kf = dataclasses.replace(kf, max_iters=int(iters), eps=float(eps))
    if feature_params:
        if "maxCorners" in feature_params:
            kf = dataclasses.replace(kf, max_corners=int(feature_params["maxCorners"]))
        if "qualityLevel" in feature_params:
            kf = dataclasses.replace(kf, quality_level=float(feature_params["qualityLevel"]))
        if "minDistance" in feature_params:
            kf = dataclasses.replace(kf, min_distance=int(feature_params["minDistance"]))
        if "blockSize" in feature_params:
            kf = dataclasses.replace(kf, block_size=int(feature_params["blockSize"]))
    return dataclasses.replace(config, keyframe=kf)


# --------------------------------------------------------------------------
# PASS 1: scan-based keyframe selection
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _make_keyframe_scan(config: PipelineConfig):
    """Build the jitted (greys_chunk, carry) -> (carry, is_kf flags) scan.

    Cached per config: ``process()`` may be called many times and a fresh
    ``jax.jit`` wrapper per call would re-trace the whole scan every run.
    """
    kf = config.keyframe

    def seed_points(grey):
        c = features.good_features(
            grey,
            max_corners=kf.max_corners,
            quality_level=kf.quality_level,
            min_distance=kf.min_distance,
            block_size=kf.block_size,
            exact_topk=kf.exact_topk,
        )
        return c.xy, c.mask

    @jax.jit
    def init_carry(grey):
        pyr = tuple(klt.build_pyramid(grey, kf.pyramid_levels))
        pts, mask = seed_points(grey)
        return (pyr, pts, mask, jnp.float32(0.0), jnp.float32(0.0))

    @functools.partial(jax.jit, static_argnames=("width_scale",))
    def scan_chunk(carry, greys, width_scale=1):
        # The keyframe rule compares an *intensity* residual (resolution-
        # independent) against threshold * width (processor.py:100). When
        # pass 1 runs on downscaled frames, the threshold must use the
        # FULL-resolution width or keyframes fire ~scale-times too often.
        # threshold_abs > 0 replaces the width coupling entirely with a
        # constant intensity budget (KeyframeConfig.threshold_abs).
        width = greys.shape[2] * width_scale
        thresh = kf.threshold_abs if kf.threshold_abs > 0 else kf.threshold * width

        def step(carry, grey):
            prev_pyr, pts, mask, acc, acc_flow = carry
            cur_pyr = tuple(klt.build_pyramid(grey, kf.pyramid_levels))
            flow = klt.lucas_kanade(
                prev_pyr,
                cur_pyr,
                pts,
                win=kf.window,
                levels=kf.pyramid_levels,
                max_iters=kf.max_iters,
                eps=kf.eps,
                point_mask=mask,
            )
            # Reference error accumulation (processor.py:95-97): NaN -> 0,
            # negatives -> 0, then the average.
            err = jnp.nan_to_num(flow.error)
            err = jnp.maximum(err, 0.0)
            n_valid = jnp.maximum(jnp.sum(mask), 1)
            acc = acc + jnp.sum(jnp.where(mask, err, 0.0)) / n_valid

            # Frame-count-invariant secondary trigger: accumulated mean
            # tracked DISPLACEMENT (working px) vs flow_threshold * working
            # width — fires on fast clips whose appearance residual the
            # reference rule under-accumulates (KeyframeConfig.flow_threshold).
            ok_flow = mask & flow.status
            n_flow = jnp.maximum(jnp.sum(ok_flow), 1)
            disp = jnp.linalg.norm(flow.points - pts, axis=-1)
            disp = jnp.nan_to_num(disp)
            acc_flow = acc_flow + jnp.sum(jnp.where(ok_flow, disp, 0.0)) / n_flow

            is_kf = acc > thresh
            if kf.flow_threshold > 0:
                is_kf = is_kf | (acc_flow > kf.flow_threshold * greys.shape[2])

            # On keyframe: reset error and reseed with Shi-Tomasi exactly at
            # the keyframe, matching the reference (processor.py:104-106).
            # The cond executes its taken branch only, so the detector runs
            # on the handful of keyframe frames, not all of them — and the
            # scan stays free of host feedback, letting the driver pipeline
            # chunk uploads against device compute.
            new_mask = mask & flow.status
            pts2, mask2 = jax.lax.cond(
                is_kf,
                lambda g: seed_points(g),
                lambda g: (flow.points, new_mask),
                grey,
            )
            acc = jnp.where(is_kf, 0.0, acc)
            acc_flow = jnp.where(is_kf, 0.0, acc_flow)
            return (cur_pyr, pts2, mask2, acc, acc_flow), is_kf

        return jax.lax.scan(step, carry, greys)

    return init_carry, scan_chunk


@jax.jit
def _enhanced_grey_batch(bgr_chunk):
    return clahe.enhanced_grey(bgr_chunk)


@functools.lru_cache(maxsize=4)
def _make_batch_scan(config: PipelineConfig):
    """(V, T, h, w) uint8 downscaled greys -> ((V, T-1) keyframe flags,
    (V, T, h, w) float32 CLAHE'd frames), ONE jitted program.

    The multi-video fast path (``parallel.batch``): with one host core the
    per-video C++ scans are strictly serial (~0.7 s per 60-frame 1080p clip
    — more than half the whole warm batch), while the device idles 90%+.
    The downscaled grey stream for a WHOLE batch is tiny (8x60 frames at
    1080p/6 = 28 MB uint8), so the batch uploads once and the keyframe
    state machine runs vmapped over videos on device. Every video
    bootstraps at its frame 0 (the batch contract: the board is visible
    from the start; keyframes without a resolvable board are still dropped
    downstream, and a video that ends with < 3 board keyframes falls back
    to the full per-video driver)."""
    init_carry, scan_chunk = _make_keyframe_scan(config)

    @functools.partial(jax.jit, static_argnames=("width_scale",))
    def batch_scan(smalls, width_scale=1):
        v, t, h, w = smalls.shape
        enh = clahe.clahe(
            smalls.reshape(v * t, h, w).astype(jnp.float32)
        ).reshape(v, t, h, w).astype(jnp.float32)

        def per_video(g):
            carry = init_carry(g[0])
            _, flags = scan_chunk(carry, g[1:], width_scale=width_scale)
            return flags

        return jax.vmap(per_video)(enh), enh

    return batch_scan


@jax.jit
def _clahe_grey_batch(grey_chunk):
    """CLAHE on uploaded grey frames — pass 1's transfer-optimal path.

    Pass 1 only needs enhanced greys for the keyframe DECISION and coarse
    board detection, so the stream ships ONE uint8 byte per downscaled
    pixel: the BGR->grey decimation runs on host in native C++
    (``io/native_ops.bgr_to_grey_down`` — NumPy is far slower, and shipping
    raw BGR is 12x the bytes). Keyframes are
    re-processed at full resolution through the exact reference path
    (CLAHE-on-LAB-L then grey — ``enhance_contrast_bgr``) in pass 2."""
    return clahe.clahe(grey_chunk.astype(jnp.float32)).astype(jnp.float32)


_ORB_MINIBATCH = 4


class _Pass2Prefetch:
    """Overlap pass-2 device compute with the pass-1 host scan.

    Pass 1 with the native host backend is host-bound (~7 ms/frame of C++
    scan) while the device sits idle, and pass 2's enhance + ORB minibatches
    depend only on keyframes already retained — so the pass-1 retain worker
    feeds keyframes here and a dedicated single worker thread dispatches the
    SAME minibatch programs ``_warm_pass2`` compiles (shape-identical jits,
    so results are bit-identical to the post-pass batched path; measured on
    the 1080p bench clip: ~0.9 s of ORB device time hides behind the 2.5 s
    host scan). Keyframes later dropped by board resolution only cost their
    wasted device time: minibatch rows are per-image independent, and
    ``finish``'s caller row-filters to the survivors.
    """

    def __init__(self, config: PipelineConfig):
        from concurrent.futures import ThreadPoolExecutor

        self._config = config
        self._pending: list = []
        self._futures: list = []
        self.count = 0
        self._pool = ThreadPoolExecutor(max_workers=1)

    def add(self, frame_dev) -> None:
        self._pending.append(frame_dev)
        self.count += 1
        if len(self._pending) == _ORB_MINIBATCH:
            batch, self._pending = self._pending, []
            self._futures.append(self._pool.submit(self._run_mb, batch))

    def _run_mb(self, frames):
        cfg = self._config
        # Wait for _warm_pass2 to finish compiling the minibatch programs:
        # dispatching concurrently would race the warmup thread into
        # compiling the same ORB program twice (~25 s each cold). The event
        # is set on warmup success OR failure; the timeout turns a
        # pathological stall (or a key mismatch bug) into the batched
        # fallback instead of a hang.
        key = (cfg.orb, cfg.pass2_enhance, tuple(frames[0].shape[:2]))
        if not _warm_event(key).wait(timeout=600):
            raise TimeoutError("pass-2 warmup never completed")
        stack = jnp.stack(frames)
        enhance = (
            _clahe_grey_batch
            if (cfg.pass2_enhance == "grey" or frames[0].ndim == 2)
            else _enhanced_grey_batch
        )
        enh = enhance(stack)
        return enh, _make_orb_minibatch(cfg.orb)(enh)

    def discard(self) -> None:
        self._pool.shutdown(wait=False)

    def finish(self, n: int):
        """((n, H, W) enhanced stack, ORB pytree with leading dim n), or
        None when nothing/mismatched was prefetched (caller falls back to
        the batched path)."""
        try:
            if self._pending:
                # Tail minibatch padded with its last real frame — the same
                # padding the batched path applies (pads trimmed below).
                batch = self._pending + [self._pending[-1]] * (
                    _ORB_MINIBATCH - len(self._pending)
                )
                self._pending = []
                self._futures.append(self._pool.submit(self._run_mb, batch))
            parts = [f.result() for f in self._futures]
            self._pool.shutdown(wait=True)
            if not parts or self.count != n:
                return None
            enh = jnp.concatenate([p[0] for p in parts])[:n]
            orb_b = jax.tree.map(
                lambda *xs: jnp.concatenate(xs)[:n], *[p[1] for p in parts]
            )
            return enh, orb_b
        except Exception:  # pragma: no cover — prefetch must never break a run
            logger.debug("pass-2 prefetch failed; using the batched path", exc_info=True)
            return None


@functools.lru_cache(maxsize=8)
def _make_orb_minibatch(orb_cfg):
    """One jitted ORB program over a fixed (_ORB_MINIBATCH, H, W) stack.

    The BRIEF sampling-weight matrix is threaded through the jit boundary as
    a runtime argument — closing over it would embed 52 MB of HLO constants
    per pyramid level and dominate the cold compile (orb.brief_bin_weights).
    """

    @jax.jit
    def orb_minibatch(stack, bin_weights):
        return jax.vmap(
            lambda g: orb.detect_and_compute(
                g,
                max_features=orb_cfg.num_features,
                num_levels=orb_cfg.num_levels,
                scale_factor=orb_cfg.scale_factor,
                fast_threshold=orb_cfg.fast_threshold,
                bin_weights=bin_weights,
                topk_recall=orb_cfg.topk_recall,
                grid_cells=orb_cfg.grid_cells,
            )
        )(stack)

    return lambda stack: orb_minibatch(stack, orb.brief_bin_weights())


def _run_minibatched(run, mb, *arrays):
    """Run a fixed-leading-axis jitted program over chunks of ``mb`` rows.

    Pads the tail by repeating the last row (results trimmed), so ``run``
    compiles once for the (mb, ...) shape regardless of the video's keyframe
    count — per-n_kf shapes otherwise recompile each pass-2 stage for every
    distinct keyframe count, and make
    the programs impossible to warm before pass 1 finishes. Rows must be
    independent under ``run`` (these stages are per-frame / per-pair maps),
    so padding cannot change real rows' results.
    """
    n = arrays[0].shape[0]
    pads = (-n) % mb
    if pads:
        arrays = [jnp.concatenate([a, jnp.repeat(a[-1:], pads, 0)]) for a in arrays]
    parts = [run(*(a[i : i + mb] for a in arrays)) for i in range(0, n + pads, mb)]
    if len(parts) == 1:
        return jax.tree.map(lambda x: x[:n], parts[0])
    return jax.tree.map(lambda *xs: jnp.concatenate(xs)[:n], *parts)


@functools.lru_cache(maxsize=8)
def _make_match_minibatch(matcher_cfg):
    """One jitted matcher program over (_ORB_MINIBATCH,) descriptor pairs."""

    @jax.jit
    def match_minibatch(q, t, qm, tm):
        return jax.vmap(
            lambda a, b, am, bm: matching.match_descriptors(
                a,
                b,
                am,
                bm,
                ratio=matcher_cfg.ratio,
                max_distance=matcher_cfg.max_distance,
                max_matches=matcher_cfg.max_matches,
                cross_check=matcher_cfg.cross_check,
            )
        )(q, t, qm, tm)

    return match_minibatch


@functools.lru_cache(maxsize=8)
def _make_subpix_minibatch(win: int, iters: int):
    """One jitted sub-pixel corner-refine program over (_ORB_MINIBATCH,)."""

    @jax.jit
    def subpix_minibatch(greys, corners):
        return jax.vmap(
            lambda g, c: chessboard.refine_corners_subpix(g, c, win=win, iters=iters)
        )(greys, corners)

    return subpix_minibatch


@functools.lru_cache(maxsize=8)
def _make_pose_stage(side_length: float):
    """One jitted program for the pose-estimation stage glue.

    Eager op-by-op dispatch makes every distinct eager op its own tiny
    program compile. Fusing the stage into one jit removes ~a dozen of them
    and lets XLA fuse the undistort/PnP math.
    """

    @jax.jit
    @matmul_highp
    def pose_stage(corners, intr, dist_coefs, obj_z0):
        und_corners = jax.vmap(
            lambda c: distortion.undistort_pixels(c, intr, dist_coefs)
        )(corners)
        # The reference's pose board: X-Z plane scaled by side_length
        # (processor.py:162-166).
        n_corners = obj_z0.shape[0]
        board_xz = jnp.zeros((n_corners, 3), corners.dtype)
        board_xz = board_xz.at[:, 0].set(obj_z0[:, 0] * side_length)
        board_xz = board_xz.at[:, 2].set(obj_z0[:, 1] * side_length)
        poses = pnp.solve_pnp_batch(
            board_xz[:, [0, 2]], (0, 2), board_xz, und_corners, intr
        )
        return und_corners, poses

    return pose_stage


@functools.lru_cache(maxsize=8)
def _make_triangulate_gate(
    tri_mode: str, scale_factor: float, min_parallax_deg: float,
    reproj_gate: float = 4.0,
):
    """One jitted program for the triangulation + outlier-gating stage.

    ``reproj_gate``: inlier threshold in the WORKING resolution's pixels
    (callers divide the full-res-denominated config value by kf_scale, so
    downscaled keyframes keep full-res-equivalent track consistency — the
    gate admitting 2x-looser tracks was the dominant volume-noise source at
    pass2_downscale=2).
    """

    @jax.jit
    @matmul_highp
    def triangulate_gate(store, ext_refined, intr, dist_coefs, projections):
        # Undistort all track coordinates once; BA/triangulation are pinhole.
        coords_und = distortion.undistort_pixels(store.coords, intr, dist_coefs)
        store = store._replace(coords=coords_und)

        first_kf, last_kf, first_xy, last_xy, tri_valid = (
            tracks_mod.triangulation_endpoints(store)
        )
        if tri_mode == "nview":
            pts3d = triangulation.triangulate_nview(
                projections, store.coords, store.obs_mask
            )
        else:
            pts3d = triangulation.triangulate_pairs(
                projections[first_kf], projections[last_kf], first_xy, last_xy
            )
        # Outlier gating the reference lacks entirely: drop tracks whose
        # initial reprojection (triangulated point vs every observation)
        # exceeds a few pixels — mismatched ORB pairs would otherwise drag
        # the global BA (the role RANSAC plays in the north-star design).
        finite = jnp.all(jnp.isfinite(pts3d), axis=1)
        cam_params_ref = projection.params_from_extrinsics(ext_refined)
        proj_all = projection.project_points(
            pts3d[:, None, :], cam_params_ref[None, :, :], intr
        )  # (T, F, 2)
        resid = jnp.linalg.norm(proj_all - store.coords, axis=-1)
        # Scale-aware gate: a keypoint detected at pyramid octave o carries
        # ~scale_factor**o px of positional uncertainty, so its legitimate
        # residual is proportionally larger (ORB-SLAM's per-octave sigma) —
        # applied per OBSERVATION, each against its own detection octave.
        sigma_obs = jnp.float32(scale_factor) ** store.octaves.astype(jnp.float32)
        resid_norm = jnp.where(store.obs_mask, resid / sigma_obs, 0.0)
        inlier = jnp.max(resid_norm, axis=1) < reproj_gate
        # Per-track parallax between the endpoint rays: depth noise scales as
        # 1/parallax, so this both gates BA inclusion (below) and is exported
        # for the volume estimators' stronger gate (low-parallax tracks pass
        # the reprojection gate while carrying large depth noise — they are
        # the points that blow up the hull volume).
        rot = ext_refined[:, :3, :3]
        centers = -jnp.einsum("fij,fi->fj", rot, ext_refined[:, :3, 3])  # (F, 3)
        r1 = pts3d - centers[first_kf]
        r2 = pts3d - centers[last_kf]
        cosang = jnp.sum(r1 * r2, axis=1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1), 1e-12
        )
        parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
        if min_parallax_deg > 0:
            inlier &= parallax_deg > min_parallax_deg
        store = store._replace(points=jnp.where(finite[:, None], pts3d, 0.0))
        return store, tri_valid & finite & inlier, jnp.sum(finite & ~inlier), parallax_deg

    return triangulate_gate


_WARMED: set = set()
_WARM_EVENTS: dict = {}
_WARM_LOCK = None  # lazily created (threading imported on first use)


def _warm_event(key):
    """Per-(config, shape) completion event for _warm_pass2 — the pass-2
    prefetcher waits on it so it never races the warmup thread into
    compiling the same ORB program twice."""
    import threading

    global _WARM_LOCK
    if _WARM_LOCK is None:
        _WARM_LOCK = threading.Lock()
    with _WARM_LOCK:
        ev = _WARM_EVENTS.get(key)
        if ev is None:
            ev = _WARM_EVENTS[key] = threading.Event()
        return ev


def _warm_pass2(config: PipelineConfig, grey_shape, small_shape=None, pattern=None) -> None:
    """Dispatch compilation of the big pass-2 programs on dummy data.

    Runs on a background thread DURING pass 1: the ORB minibatch program
    is the largest cold compile of the pipeline, and its shape depends only on the image size and the ORB config — both known
    as soon as the first chunk arrives. Overlapping the compile with pass-1
    streaming removes it from the cold critical path.

    ``MEATMODELER_WARM_STAGES=1`` additionally warms the other fixed-shape
    stage programs in parallel after the ORB event (default off; see
    ``_warm_stage_programs``).
    """
    key = (config.orb, config.pass2_enhance, grey_shape)
    ev = _warm_event(key)
    if key in _WARMED:
        # Programs already compiled this process: a repeat dummy execution
        # would cost ~3 s of device occupancy that pass 1's first scan
        # chunks then queue behind on every warm run.
        ev.set()
        return
    try:
        h, w = grey_shape
        zeros = jnp.zeros((_ORB_MINIBATCH, h, w), jnp.float32)
        if config.pass2_enhance == "bgr_lab":
            _enhanced_grey_batch(jnp.zeros((_ORB_MINIBATCH, h, w, 3), jnp.uint8))
        else:
            _clahe_grey_batch(zeros)
        run_orb = _make_orb_minibatch(config.orb)
        jax.block_until_ready(run_orb(zeros))
        _WARMED.add(key)
        logger.debug("pass-2 warmup complete")
    except Exception:  # pragma: no cover — warmup must never break the run
        logger.debug("pass-2 warmup failed", exc_info=True)
    finally:
        ev.set()
    import os

    if os.environ.get("MEATMODELER_WARM_STAGES", "") not in ("", "0"):
        _warm_stage_programs(config, grey_shape, small_shape, pattern)


def _warm_stage_programs(config, grey_shape, small_shape, pattern) -> None:
    """Parallel warmup of the remaining fixed-shape stage programs.

    Off by default (``MEATMODELER_WARM_STAGES=1`` turns it on): compiling
    the stage programs concurrently with pass 1 can queue the first real
    consumer (board detect) behind every other program, where compiling
    them in place loads them in consumption order. Whether it pays on the
    GPU is unmeasured.
    """
    import threading

    h, w = grey_shape
    cb = config.chessboard

    def safe(fn):
        def run():
            try:
                fn()
            except Exception:  # pragma: no cover — warmup must never break a run
                logger.debug("stage warmup failed", exc_info=True)

        return run

    targets = []
    if (
        small_shape is not None
        and pattern is not None
        and cb.detector in ("auto", "device")
        and pattern[0] * pattern[1] <= cb.detect_candidates
    ):
        def warm_board():
            run = _make_board_detect_batch(
                tuple(pattern), cb.detect_candidates, cb.detect_tol, cb.detect_exact_topk
            )
            jax.block_until_ready(
                run(jnp.zeros((_DETECT_MINIBATCH,) + tuple(small_shape), jnp.uint8))
            )

        targets.append(warm_board)

    def warm_match():
        kf = config.orb.num_features
        run = _make_match_minibatch(config.matcher)
        d = jnp.zeros((_ORB_MINIBATCH, kf, 32), jnp.uint8)
        m = jnp.zeros((_ORB_MINIBATCH, kf), bool)
        jax.block_until_ready(run(d, d, m, m))

    targets.append(warm_match)

    if pattern is not None:
        n_c = pattern[0] * pattern[1]

        def warm_subpix():
            run = _make_subpix_minibatch(cb.subpix_window, cb.subpix_iters)
            jax.block_until_ready(
                run(
                    jnp.zeros((_ORB_MINIBATCH, h, w), jnp.float32),
                    jnp.zeros((_ORB_MINIBATCH, n_c, 2), jnp.float32),
                )
            )

        def warm_pose_and_ba():
            # Plausible dummy geometry (centered board, sane focal) so the
            # LM warms in a couple of iterations instead of walking the full
            # damping schedule on garbage.
            obj_z0 = calibration.chessboard_object_points(pattern, jnp.float32)
            intr = jnp.asarray(
                [[500.0, 0.0, w / 2.0], [0.0, 500.0, h / 2.0], [0.0, 0.0, 1.0]],
                jnp.float32,
            )
            corners = (
                jnp.tile(obj_z0[None] * 40.0, (_ORB_MINIBATCH, 1, 1))
                + jnp.asarray([w / 3.0, h / 3.0], jnp.float32)
            )
            pose_stage = _make_pose_stage(cb.side_length)
            und, poses = pose_stage(
                corners, intr, jnp.zeros(5, jnp.float32), obj_z0
            )
            # Same static solver config construction as the pose_ba stage —
            # the jit is keyed on it, so the warm must match exactly.
            pose_cfg = dataclasses.replace(
                config.solver,
                ftol=min(config.solver.ftol, 1e-7),
                max_iters=max(config.solver.max_iters, 100),
            )
            ext0 = projection.extrinsics_from_params(poses)
            jax.block_until_ready(
                bundle_adjust.adjust_pose(
                    ext0,
                    intr,
                    und.reshape(-1, 2),
                    pattern=tuple(pattern),
                    side_length=cb.side_length,
                    config=pose_cfg,
                )[0]
            )

        targets += [warm_subpix, warm_pose_and_ba]

    for t in targets:
        threading.Thread(target=safe(t), daemon=True).start()


def _board_fit_residual(corners: np.ndarray, pattern) -> float:
    """Max residual (px) of a planar-homography fit of the board grid.

    A genuine chessboard is exactly planar, so correctly detected corners fit
    a homography to sub-pixel residual; a mis-detection (a corner snapped to
    a neighboring saddle — the half-res detector's failure mode on oblique
    views) shows up as a multi-pixel outlier.
    """
    cols, rows = pattern
    gx, gy = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    obj = np.stack([gx.ravel(), gy.ravel()], axis=1)
    img = np.asarray(corners, np.float64)
    n = len(obj)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = obj
    a[0::2, 2] = 1.0
    a[0::2, 6:8] = -obj * img[:, :1]
    a[0::2, 8] = -img[:, 0]
    a[1::2, 3:5] = obj
    a[1::2, 5] = 1.0
    a[1::2, 6:8] = -obj * img[:, 1:2]
    a[1::2, 8] = -img[:, 1]
    h = np.linalg.svd(a)[2][-1].reshape(3, 3)
    den = obj @ h[2, :2] + h[2, 2]
    proj = (obj @ h[:2, :2].T + h[:2, 2]) / den[:, None]
    return float(np.abs(proj - img).max())


def _detect_board_host(grey_small, pattern, scale, fast_probe=False):
    """Detect the chessboard on a (possibly downscaled) host grey image.

    Returns full-resolution corner estimates or None. The result is
    validated with a planar-homography fit — a genuine board is exactly
    planar, so a corner snapped to a neighboring saddle (the half-res
    detector's failure mode on oblique views) shows up as a multi-pixel
    outlier and the detection is rejected rather than corrupting
    calibration. Sub-pixel refinement happens later on device at full
    resolution. ``fast_probe`` — see ``chessboard.find_chessboard``.
    """
    c = chessboard.find_chessboard(grey_small, pattern, fast_probe=fast_probe)
    if c is None:
        return None
    c = chessboard.canonicalize_corners(np.asarray(c, np.float32) * scale, pattern)
    if _board_fit_residual(c, pattern) > 3.0 * scale:
        return None
    return c


def _hunt_board(chunk, grey_host, greys_dev, real_len, pattern, scale, config, probe, metrics):
    """Bootstrap board hunt over one chunk: the index of the first frame
    that shows the board and its full-res corners, or (None, None).

    The host detector (OpenCV, as ``processor.py:315``) hunts unless the
    config asks for the device detector, or asks for "auto" and OpenCV
    cannot be imported; then the on-device detector runs over the chunk's
    CLAHE'd greys (``greys_dev``, or computed here from ``grey_host``). The
    counter ``board_bootstrap_detector`` records which one started the scan.
    """
    detector = config.chessboard.detector
    if detector == "device" or (
        detector == "auto" and not chessboard.host_detector_available()
    ):
        if greys_dev is None:
            greys_dev = _clahe_grey_batch(jnp.asarray(grey_host[:real_len]))
        cand = _detect_board_device_batch(
            [greys_dev[i] for i in range(real_len)], pattern, scale,
            config.chessboard,
        )
        for i, c0 in enumerate(cand):
            if c0 is not None:
                metrics.count("board_bootstrap_detector", "device")
                return i, c0
            probe.note_miss()
        return None, None
    for i in range(real_len):
        if probe.exhausted:
            break
        fast = probe.fast_mode
        c0 = _detect_board_host(grey_host[i], pattern, scale, fast_probe=fast)
        if c0 is None and scale > 1:
            frame = np.asarray(chunk[i])
            grey_full = (
                native_ops.bgr_to_grey_down(frame[None], 1)[0]
                if frame.ndim == 3
                else frame
            )
            c0 = _detect_board_host(grey_full, pattern, 1, fast_probe=fast)
        if c0 is not None:
            metrics.count("board_bootstrap_detector", "host")
            return i, c0
        probe.note_miss()
    return None, None


class _BoardProbe:
    """Bootstrap board-hunt budget for board-free leading frames.

    Active only when the marker-free fallback is armed (it is the safety
    net): after ``config.board_probe_frames`` board-free frames the hunt
    stops and pass 1 returns empty, engaging the marker-free path without
    scanning (and full-res cv2-detecting) the whole clip — the reference
    busy-loops forever here (``processor.py:315-319``). The first few
    probes use the full detector (maximum robustness for the common
    board-at-start case); later ones use cv2's FAST_CHECK mode, whose rare
    false negatives the fallback absorbs.
    """

    _FULL_PROBES = 3  # leading probes that use the full detector

    def __init__(self, config: PipelineConfig, armed: bool):
        self.enabled = (
            armed and config.markerless_fallback and config.board_probe_frames > 0
        )
        self.budget = config.board_probe_frames
        self.probed = 0

    @property
    def fast_mode(self) -> bool:
        return self.enabled and self.probed >= self._FULL_PROBES

    @property
    def exhausted(self) -> bool:
        return self.enabled and self.probed >= self.budget

    def note_miss(self) -> None:
        self.probed += 1


_DETECT_MINIBATCH = 8


@functools.lru_cache(maxsize=8)
def _make_board_detect_batch(pattern, max_candidates, tol, exact_topk=False):
    """One jitted vmapped board-detect program over a fixed-size stack."""

    @jax.jit
    def board_detect_batch(stack):
        # uint8 stacks arrive from the host pass-1 backend (CLAHE'd smalls
        # round-trip as one byte per pixel); the detector math is float.
        stack = stack.astype(jnp.float32)
        return jax.vmap(
            lambda g: board_detect.find_chessboard_device(
                g, pattern=pattern, max_candidates=max_candidates, tol=tol,
                exact_topk=exact_topk,
            )
        )(stack)

    return board_detect_batch


def _detect_board_device_dispatch(smalls_dev, pattern, cb_cfg):
    """Dispatch half of the batched on-device board detection: returns the
    fused (n_padded, 1 + 2N) DEVICE array (ok flag + flattened corners per
    frame) without reading it back — callers (the multi-video batch) can
    overlap the detection's device time with other host work and coalesce
    many videos' results into one readback."""
    run = _make_board_detect_batch(
        tuple(pattern), cb_cfg.detect_candidates, cb_cfg.detect_tol,
        cb_cfg.detect_exact_topk,
    )
    mb = _DETECT_MINIBATCH
    n = len(smalls_dev)
    padded = list(smalls_dev) + [smalls_dev[-1]] * ((-n) % mb)
    dets = [run(jnp.stack(padded[i : i + mb])) for i in range(0, len(padded), mb)]
    cor_flat = jnp.concatenate(
        [d.corners.reshape(d.corners.shape[0], -1) for d in dets]
    )
    ok_col = jnp.concatenate([d.ok for d in dets]).astype(cor_flat.dtype)[:, None]
    return jnp.concatenate([ok_col, cor_flat], axis=1)


def _detect_board_finish(fused_np, n, pattern, scale):
    """Host half: fused rows -> list of canonicalized full-res corners or
    None, with the planar-homography validation gate."""
    fused_np = np.asarray(fused_np)[:n]
    ok = fused_np[:, 0] > 0.5
    n_pts = (fused_np.shape[1] - 1) // 2
    corners = fused_np[:, 1:].reshape(n, n_pts, 2)
    out = []
    for i in range(n):
        if not ok[i]:
            out.append(None)
            continue
        c = chessboard.canonicalize_corners(
            np.asarray(corners[i], np.float32) * scale, pattern
        )
        out.append(None if _board_fit_residual(c, pattern) > 3.0 * scale else c)
    return out


def _detect_board_device_batch(smalls_dev, pattern, scale, cb_cfg):
    """BATCHED on-device detection over a list of device-resident greys.

    One vmapped program + ONE readback for the whole keyframe set, in place
    of a device round trip per keyframe. Results are validated by the same planar-homography gate as the host
    path. Returns a list of full-res corner arrays or None per frame.
    """
    if not smalls_dev:
        return []
    fused = _detect_board_device_dispatch(smalls_dev, pattern, cb_cfg)
    return _detect_board_finish(np.asarray(fused), len(smalls_dev), pattern, scale)


def _resolve_board_corners(
    kf_frames, kf_corners, kf_small_dev, kf_small_host, kf_indices, pattern,
    scale, config, metrics, kf_scale=1, dev_results=None,
):
    """Post-pass-1 board detection + sequential orientation anchoring.

    Entries of ``kf_corners`` that are None run through the batched device
    detector (one program, one readback) with a host cv2 fallback on the
    RETAINED host small greys (zero device readbacks). Boardless keyframes
    are dropped (processor.py:369-371). All corners — detected or known —
    then get the sequential 180-degree orientation anchoring (detectors flip
    the symmetric grid between frames).

    Returns (kept kf_frames, kept corners, kept global frame indices).
    """
    mode = config.chessboard.detector
    # In auto mode a pattern larger than the candidate budget falls through
    # to the host detector; detector='device' keeps the hard ValueError.
    device_fits = pattern[0] * pattern[1] <= config.chessboard.detect_candidates
    n = len(kf_frames)
    pending = [i for i in range(n) if kf_corners[i] is None]
    host_detector = chessboard.host_detector_available()

    if dev_results is None:
        # (The multi-video batch path passes precomputed results from ONE
        # cross-video detection program + readback.)
        dev_results = {}
        if pending and (mode == "device" or (mode == "auto" and device_fits)):
            cand = _detect_board_device_batch(
                [kf_small_dev[i] for i in pending], pattern, scale,
                config.chessboard,
            )
            dev_results = dict(zip(pending, cand))

    out_frames, out_corners, out_indices = [], [], []
    prev = None
    for i in range(n):
        c = kf_corners[i]
        if c is None:
            c = dev_results.get(i)
            device_ran = i in dev_results
            if c is None and mode == "auto" and not host_detector:
                # No OpenCV: the keyframe is dropped like any boardless one,
                # but counted, so a run that lost keyframes this way says so.
                metrics.add("board_detect_host_skipped", 1)
            elif c is None and mode in ("host", "auto"):
                # cv2 fallback runs on the CLAHE'd small first (low-contrast
                # boards detect better enhanced; the readback is rare-path
                # only), then the raw host grey.
                enh = np.clip(
                    np.round(np.asarray(kf_small_dev[i])), 0, 255
                ).astype(np.uint8)
                c = _detect_board_host(enh, pattern, scale)
                if c is None:
                    c = _detect_board_host(kf_small_host[i], pattern, scale)
                if c is None and scale > kf_scale:
                    # Rare fallback: read back the retained keyframe (shipped
                    # at 1/kf_scale resolution) and detect on that.
                    frame = np.asarray(kf_frames[i])
                    grey_full = (
                        native_ops.bgr_to_grey_down(frame[None], 1)[0]
                        if frame.ndim == 3
                        else frame
                    )
                    c = _detect_board_host(grey_full, pattern, kf_scale)
                if device_ran and c is not None:
                    # Count only genuine device-detector misses: the host
                    # found a board the device did not (board-free frames
                    # are not fallbacks — both detectors agree there).
                    metrics.add("board_detect_host_fallbacks", 1)
        if c is None:
            continue  # boardless keyframes dropped (processor.py:369-371)
        c = chessboard.orient_corners_to(c, prev)
        prev = c
        out_frames.append(kf_frames[i])
        out_corners.append(c)
        out_indices.append(kf_indices[i])
    return out_frames, out_corners, out_indices


def _run_pass1(
    video, config, pattern, known_corners, metrics, init_carry, scan_chunk,
    markerfree: bool = False, prefetch: "_Pass2Prefetch | None" = None,
):
    """PASS 1 driver: stream chunks, run the keyframe scan, detect boards.

    ``markerfree=True`` (the fallback re-pass for board-free videos): the
    scan bootstraps at frame 0 instead of waiting for the first board
    (processor.py:315-319), board detection is skipped entirely, and every
    flagged keyframe is retained with ``None`` corners.

    Pipelined: chunk k+1's upload + CLAHE + scan are dispatched before chunk
    k's keyframe flags are read back, so uploads stream continuously instead
    of stalling on every round trip. The scan reseeds
    itself on device (see ``_make_keyframe_scan``). Board detection is NOT
    done here (except bootstrap): keyframes are retained with their device
    and host small greys, and ``_resolve_board_corners`` batch-detects after
    the pass, in one program instead of a device round trip per keyframe
    inside pass 1. Pass-1 frames are downscaled by ``config.pass1_downscale``
    (auto: 4x for >=1080p, 2x for >=720p); keyframes upload at full
    resolution for pass 2 (BGR, or native-converted grey in
    ``pass2_enhance="grey"`` mode).

    Returns (kf_frames DEVICE arrays, kf_corners (known/bootstrap entries
    set, rest None), kf_small_dev, kf_small_host, frames_total, scale,
    kf_scale).
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    source = video_mod.FrameSource(video)
    scale = config.pass1_downscale
    # Pass-2 keyframe resolution divisor, resolved on the first chunk when
    # auto. Boxed because retain_keyframe closes over it from the resolver
    # worker thread.
    p2s_box = [config.pass2_downscale]
    with metrics.stage("pass1_keyframes"):
        carry = None
        frame_idx = 0  # global index of the next chunk's first frame
        kf_frames = []  # DEVICE full-res uint8 keyframes (BGR, or grey in "grey" mode)
        kf_corners = []  # known/bootstrap corners (full-res px) or None per keyframe
        kf_small_dev = []  # CLAHE'd downscaled device grey per keyframe
        kf_small_host = []  # raw downscaled host grey per keyframe
        kf_indices = []  # global frame index of each keyframe (parity/GT eval)

        # The caller's default device, captured HERE: uploads below may run
        # on the resolver worker thread, and jax.default_device is
        # thread-local — without pinning, a pipelined ingest stage's
        # keyframes would land on the wrong device and re-transfer later.
        target_device = jax.default_device.value

        def retain_keyframe(frame_host, small_dev, small_host, corners, global_idx):
            """Upload one keyframe at 1/kf_scale resolution; in "grey" pass-2
            mode it ships as one byte per pixel (native host conversion)."""
            p2s = p2s_box[0] or 1
            frame_host = np.asarray(frame_host)
            if config.pass2_enhance == "grey" and frame_host.ndim == 3:
                frame_host = native_ops.bgr_to_grey_down(frame_host[None], p2s)[0]
            elif p2s > 1:  # BGR (lab mode) or already-grey source
                oh, ow = frame_host.shape[0] // p2s, frame_host.shape[1] // p2s
                frame_host = frame_host[: oh * p2s : p2s, : ow * p2s : p2s]
            kf_frames.append(
                jax.device_put(np.ascontiguousarray(frame_host), target_device)
            )
            if prefetch is not None:
                prefetch.add(kf_frames[-1])
            kf_corners.append(corners)
            kf_small_dev.append(small_dev)
            kf_small_host.append(np.ascontiguousarray(small_host))
            kf_indices.append(int(global_idx))

        def known_of(global_idx):
            return chessboard.canonicalize_corners(
                np.asarray(known_corners[global_idx], np.float32), pattern
            )

        def resolve(flags_dev, greys_dev, grey_host, chunk_host, idx0, real_len, offset):
            t0 = _time.perf_counter()
            flags = np.array(flags_dev)[:real_len]
            flags[:offset] = False  # pre-board frames must not fire
            t1 = _time.perf_counter()
            metrics.add("pass1_sync_s", t1 - t0)
            for i in np.nonzero(flags)[0]:
                c = known_of(idx0 + int(i)) if known_corners is not None else None
                # Upload the full-res keyframe NOW, between chunk uploads,
                # so pass 2 starts with everything already device-resident.
                # Only keyframes ship at full resolution.
                retain_keyframe(
                    chunk_host[i], greys_dev[i], grey_host[i], c, idx0 + int(i)
                )
            logger.debug(
                "pass1 resolve@%d: sync %.3fs (%d kf)", idx0, t1 - t0, int(flags.sum())
            )

        # The resolver runs on a single worker thread so chunk k's flag
        # readback + keyframe uploads overlap the decimation and device
        # compute of chunk k+1 (single worker = keyframe order preserved).
        executor = ThreadPoolExecutor(max_workers=1)
        futures = []
        probe = _BoardProbe(config, armed=not markerfree and known_corners is None)

        warm_thread = None
        for chunk in source.chunks(config.frame_chunk):
            if scale == 0:  # auto (resolve on first chunk)
                min_dim = min(chunk.shape[1], chunk.shape[2])
                scale = 4 if min_dim >= 1060 else 2 if min_dim >= 720 else 1
            if p2s_box[0] == 0:  # auto keyframe resolution
                min_dim = min(chunk.shape[1], chunk.shape[2])
                p2s_box[0] = 2 if min_dim >= 1060 else 1
            if warm_thread is None:
                # Compile pass 2's programs concurrently with pass-1 streaming.
                import threading

                p2s = p2s_box[0]
                warm_thread = threading.Thread(
                    target=_warm_pass2,
                    args=(
                        config,
                        (chunk.shape[1] // p2s, chunk.shape[2] // p2s),
                        (chunk.shape[1] // scale, chunk.shape[2] // scale),
                        None if markerfree else tuple(pattern),
                    ),
                    daemon=True,
                )
                warm_thread.start()
            # Pad ragged chunks up front so every device op sees one shape.
            real_len = len(chunk)
            if real_len < config.frame_chunk:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], config.frame_chunk - real_len, axis=0)]
                )
            # Native host BGR->grey decimation, then ship one byte per
            # downscaled pixel (see _clahe_grey_batch).
            t_d0 = _time.perf_counter()
            if chunk.ndim == 4:
                grey_host = native_ops.bgr_to_grey_down(chunk, scale)
            else:  # already-grey source
                grey_host = chunk[:, ::scale, ::scale]
            t_d1 = _time.perf_counter()
            greys = _clahe_grey_batch(jnp.asarray(grey_host))
            t_d2 = _time.perf_counter()
            metrics.add("pass1_decim_s", t_d1 - t_d0)
            metrics.add("pass1_upload_s", t_d2 - t_d1)

            idx0 = frame_idx
            offset = 0
            if carry is None:
                # Discard leading frames until the chessboard is visible
                # (processor.py:315-319) — but without crashing on
                # board-free videos (the reference loops forever, SURVEY §5.3).
                # Markerfree/known-corner modes bootstrap at frame 0.
                start = None
                if markerfree or known_corners is not None:
                    start = 0
                    c0 = known_of(idx0) if known_corners is not None else None
                    retain_keyframe(chunk[0], greys[0], grey_host[0], c0, idx0)
                else:
                    start, c0 = _hunt_board(
                        chunk, grey_host, greys, real_len, pattern, scale,
                        config, probe, metrics,
                    )
                    if start is not None:
                        retain_keyframe(
                            chunk[start], greys[start], grey_host[start], c0,
                            idx0 + start,
                        )
                if start is None:
                    frame_idx += real_len
                    if probe.exhausted:
                        # Budgeted hunt over: stop consuming and return
                        # empty — process() engages the marker-free path.
                        metrics.count("board_probe_exhausted", probe.probed)
                        break
                    continue
                carry = init_carry(greys[start])
                offset = start + 1
                frame_idx += real_len
                if offset >= real_len:
                    continue
            else:
                frame_idx += real_len

            t_s0 = _time.perf_counter()
            carry, flags = scan_chunk(carry, greys, width_scale=scale)
            metrics.add("pass1_scan_dispatch_s", _time.perf_counter() - t_s0)
            futures.append(
                executor.submit(
                    resolve, flags, greys, grey_host, chunk, idx0, real_len, offset
                )
            )

        t_w0 = _time.perf_counter()
        executor.shutdown(wait=True)
        metrics.add("pass1_drain_s", _time.perf_counter() - t_w0)
        for fut in futures:
            fut.result()  # surface worker exceptions

        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes_selected", len(kf_frames))
    return (
        kf_frames, kf_corners, kf_small_dev, kf_small_host, kf_indices,
        frame_idx, scale, p2s_box[0] or 1,
    )


def _run_pass1_host(
    video, config, pattern, known_corners, metrics, markerfree: bool = False,
    prefetch: "_Pass2Prefetch | None" = None,
):
    """PASS 1 on the host CPU (``config.pass1_backend="host"``).

    Same contract and return tuple as :func:`_run_pass1`, but the keyframe
    state machine runs in native C++ (``io/native_pass1.py`` over
    ``native/pass1.cpp``) and the per-frame stream NEVER touches the device:
    only selected keyframes upload (at 1080p: ~60 MB of downscaled stream
    bytes vs ~10 MB of half-res keyframes), plus one byte-per-pixel CLAHE'd
    small per keyframe for the batched device board detection.

    Keyframe uploads run on a single worker thread so they overlap the next
    chunk's decimation + scan; the pass-2 compile warmup thread starts on
    the first chunk exactly as in the device driver.
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    from meatmodeler_tpu.io.native_pass1 import HostPass1Scanner

    source = video_mod.FrameSource(video)
    scale = config.pass1_downscale
    p2s_box = [config.pass2_downscale]
    with metrics.stage("pass1_keyframes"):
        frame_idx = 0
        kf_frames = []  # DEVICE keyframes (1/p2s res; BGR or grey per mode)
        kf_corners = []  # known/bootstrap corners (full-res px) or None
        kf_small_dev = []  # HOST uint8 CLAHE'd smalls (uploaded in one batch
        #                    by the device board detector if it runs)
        kf_small_host = []  # raw downscaled host grey per keyframe
        kf_indices = []  # global frame index of each keyframe (parity/GT eval)
        target_device = jax.default_device.value
        scanner = None
        warm_thread = None
        executor = ThreadPoolExecutor(max_workers=1)
        futures = []
        probe = _BoardProbe(config, armed=not markerfree and known_corners is None)

        def retain_keyframe(frame_host, small_enh, small_host, corners, global_idx):
            p2s = p2s_box[0] or 1
            frame_host = np.asarray(frame_host)
            if config.pass2_enhance == "grey" and frame_host.ndim == 3:
                frame_host = native_ops.bgr_to_grey_down(frame_host[None], p2s)[0]
            elif p2s > 1:
                oh, ow = frame_host.shape[0] // p2s, frame_host.shape[1] // p2s
                frame_host = frame_host[: oh * p2s : p2s, : ow * p2s : p2s]
            kf_frames.append(
                jax.device_put(np.ascontiguousarray(frame_host), target_device)
            )
            if prefetch is not None:
                prefetch.add(kf_frames[-1])
            kf_corners.append(corners)
            kf_small_dev.append(
                np.clip(np.round(small_enh), 0, 255).astype(np.uint8)
            )
            kf_small_host.append(np.ascontiguousarray(small_host))
            kf_indices.append(int(global_idx))

        def known_of(global_idx):
            return chessboard.canonicalize_corners(
                np.asarray(known_corners[global_idx], np.float32), pattern
            )

        def resolve(flags, enhanced, grey_host, chunk_host, idx0):
            for i in np.nonzero(flags)[0]:
                c = known_of(idx0 + int(i)) if known_corners is not None else None
                retain_keyframe(
                    chunk_host[i], enhanced[i], grey_host[i], c, idx0 + int(i)
                )

        for chunk in source.chunks(config.frame_chunk):
            if scale == 0:  # auto (resolve on first chunk)
                min_dim = min(chunk.shape[1], chunk.shape[2])
                scale = 4 if min_dim >= 1060 else 2 if min_dim >= 720 else 1
            if p2s_box[0] == 0:
                min_dim = min(chunk.shape[1], chunk.shape[2])
                p2s_box[0] = 2 if min_dim >= 1060 else 1
            if warm_thread is None:
                import threading

                p2s = p2s_box[0]
                warm_thread = threading.Thread(
                    target=_warm_pass2,
                    args=(
                        config,
                        (chunk.shape[1] // p2s, chunk.shape[2] // p2s),
                        (chunk.shape[1] // scale, chunk.shape[2] // scale),
                        None if markerfree else tuple(pattern),
                    ),
                    daemon=True,
                )
                warm_thread.start()
            real_len = len(chunk)
            t_d0 = _time.perf_counter()
            if chunk.ndim == 4:
                grey_host = native_ops.bgr_to_grey_down(chunk, scale)
            else:
                grey_host = np.ascontiguousarray(chunk[:, ::scale, ::scale])
            metrics.add("pass1_decim_s", _time.perf_counter() - t_d0)
            if scanner is None:
                scanner = HostPass1Scanner(
                    config, grey_host.shape[1], grey_host.shape[2],
                    full_width=chunk.shape[2],
                )

            idx0 = frame_idx
            frame_idx += real_len
            bootstrap_at = -1
            boot_corners = None
            if not scanner.initialized:
                # Discard leading frames until the chessboard is visible
                # (processor.py:315-319); marker-free / known-corner modes
                # bootstrap at frame 0.
                start = None
                if markerfree or known_corners is not None:
                    start = 0
                    if known_corners is not None:
                        boot_corners = known_of(idx0)
                else:
                    start, boot_corners = _hunt_board(
                        chunk, grey_host, None, real_len, pattern, scale,
                        config, probe, metrics,
                    )
                if start is None:
                    if probe.exhausted:
                        # Budgeted hunt over: stop consuming the stream and
                        # return empty — process() engages the marker-free
                        # path (n_kf < 3 triggers the fallback).
                        metrics.count("board_probe_exhausted", probe.probed)
                        break
                    continue
                bootstrap_at = start

            t_s0 = _time.perf_counter()
            flags, enhanced = scanner.scan(
                grey_host[:real_len], bootstrap_at=bootstrap_at
            )
            metrics.add("pass1_host_scan_s", _time.perf_counter() - t_s0)
            if bootstrap_at >= 0:
                # The bootstrap frame is always a keyframe (reference seeds
                # its state there); retained on the main thread — no resolve
                # task has been submitted yet, so ordering holds.
                retain_keyframe(
                    chunk[bootstrap_at], enhanced[bootstrap_at],
                    grey_host[bootstrap_at], boot_corners, idx0 + bootstrap_at,
                )
                flags[: bootstrap_at + 1] = False
            futures.append(
                executor.submit(resolve, flags, enhanced, grey_host, chunk, idx0)
            )

        t_w0 = _time.perf_counter()
        executor.shutdown(wait=True)
        metrics.add("pass1_drain_s", _time.perf_counter() - t_w0)
        for fut in futures:
            fut.result()

        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes_selected", len(kf_frames))
    return (
        kf_frames, kf_corners, kf_small_dev, kf_small_host, kf_indices,
        frame_idx, scale, p2s_box[0] or 1,
    )


# --------------------------------------------------------------------------
# marker-free pose bootstrap
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _make_markerfree_stages(reproj_gate: float):
    """Two jitted fixed-shape programs for the incremental marker-free chain:
    masked n-view re-triangulation + validity gating, and reprojection-based
    support counting. Shapes never change across chain steps (observations
    beyond the current keyframe are masked), so each compiles once."""

    @jax.jit
    @matmul_highp
    def triangulate_known(params, known_mask, coords, obs_mask, intr):
        # Poses for unknown keyframes are placeholders; masking their
        # observations out of the DLT and the gates keeps them inert.
        m = obs_mask & known_mask[None, :]
        exts = projection.extrinsics_from_params(params)
        projs = projection.projection_from_extrinsic(intr, exts)
        pts3d = triangulation.triangulate_nview(projs, coords, m)
        finite = jnp.all(jnp.isfinite(pts3d), axis=1)
        proj_all = projection.project_points(
            pts3d[:, None, :], params[None, :, :], intr
        )  # (T, F, 2)
        resid = jnp.linalg.norm(proj_all - coords, axis=-1)
        resid_ok = jnp.where(m, resid, 0.0)
        # Positive depth in every keyframe that observed the track.
        cam_z = (
            jnp.einsum("fj,tj->tf", exts[:, 2, :3], pts3d) + exts[None, :, 2, 3]
        )
        in_front = jnp.all(jnp.where(m, cam_z > 1e-3, True), axis=1)
        valid = (
            finite
            & in_front
            & (jnp.sum(m, axis=1) >= 2)
            & (jnp.max(resid_ok, axis=1) < reproj_gate)
        )
        return jnp.where(finite[:, None], pts3d, 0.0), valid

    @jax.jit
    @matmul_highp
    def pnp_support(pose, pts3d, xy, m, intr):
        proj = projection.project_points(pts3d, pose[None].repeat(pts3d.shape[0], 0), intr)
        resid = jnp.linalg.norm(proj - xy, axis=-1)
        return m & (resid < 2.0 * reproj_gate)

    return triangulate_known, pnp_support


@functools.lru_cache(maxsize=8)
def _make_chain_step(reproj_gate: float, pose_cfg, chain_cfg):
    """ONE jitted program for a full incremental-chain step: masked
    re-triangulation -> 2-start PnP -> outlier-trimmed re-solve -> masked
    warm-started BA, with the keyframe index traced so a single compile
    serves every step of every video in the same shape bucket.

    The split version dispatched 4 programs and paid TWO host<->device
    syncs per step (the PnP winner selection and the post-BA pose/damping
    readback). Here the winner is argmax'd on device, the trimmed re-solve
    is computed unconditionally and selected by predicate (one extra 6-dof
    LM — cheaper than a round trip), and the host loop just chains
    device handles; the per-step support counts and visible-track gates
    come back in ONE fused fetch after the last step.

    All problem arrays enter as ARGUMENTS, not closures — a closed-over
    device array is baked into the compiled program as a constant, which
    would both bloat the executable and force a recompile per video.
    """
    triangulate_known, pnp_support = _make_markerfree_stages(reproj_gate)
    from meatmodeler_tpu.solvers import bundle_adjust

    @jax.jit
    @matmul_highp
    def chain_step(params, known, lam, i, coords, obs_mask, obs_all, fidx_all, pidx_all, intr):
        pts3d, valid3d = triangulate_known(params, known, coords, obs_mask, intr)
        m = valid3d & jnp.take(obs_mask, i, axis=1)
        xy = jnp.take(coords, i, axis=1)  # (T, 2)

        # Constant-velocity SE(3) extrapolation E_pred = (E_{i-1} E_{i-2}^-1)
        # E_{i-1}, on device (the host scipy version forced params to live on
        # host between steps).
        e1 = projection.extrinsics_from_params(
            jnp.take(params, i - 1, axis=0)[None], homogeneous=True
        )[0]
        e2 = projection.extrinsics_from_params(
            jnp.take(params, i - 2, axis=0)[None], homogeneous=True
        )[0]
        r2, t2 = e2[:3, :3], e2[:3, 3]
        e2inv = jnp.eye(4, dtype=e2.dtype).at[:3, :3].set(r2.T).at[:3, 3].set(-r2.T @ t2)
        e_pred = (e1 @ e2inv) @ e1
        p_pred = jnp.concatenate([so3.log(e_pred[:3, :3]), e_pred[:3, 3]])

        # PnP: MULTI-START pose-only LM from (a) the previous keyframe's
        # pose and (b) the extrapolation — the previous-pose init alone
        # biases LM toward a rotation-dominant basin on turntable-like
        # motion; the extrapolated start carries the translation momentum
        # that basin lacks. Both ride ONE (2, ...) batched solve.
        starts = jnp.stack([jnp.take(params, i - 1, axis=0), p_pred])  # (2, 6)
        pts2 = jnp.broadcast_to(pts3d, (2,) + pts3d.shape)
        xy2 = jnp.broadcast_to(xy, (2,) + xy.shape)
        m2 = jnp.broadcast_to(m, (2,) + m.shape)
        cands = bundle_adjust.pose_only_refine(
            starts, pts2, intr, xy2, m2, config=pose_cfg
        )  # (2, 6)
        inl2 = jax.vmap(lambda p: pnp_support(p, pts3d, xy, m, intr))(cands)
        counts = jnp.sum(inl2, axis=1)
        best = jnp.argmax(counts)
        refined = jnp.take(cands, best, axis=0)
        inl = jnp.take(inl2, best, axis=0)
        n_m = jnp.sum(m)
        n_inl = jnp.take(counts, best, axis=0)

        # Outlier-trimmed re-solve on the winner, selected by predicate.
        trimmed = bundle_adjust.pose_only_refine(
            refined[None], pts3d[None], intr, xy[None], inl[None], config=pose_cfg
        )[0]
        refined = jnp.where((n_inl >= 6) & (n_inl < n_m), trimmed, refined)

        params = params.at[i].set(refined)
        known = known.at[i].set(True)

        # In-chain BA over keyframes 0..i (same masked fixed-cap solve as
        # the split version; the previous step's exit damping warm-starts
        # this one).
        pts3d, valid3d = triangulate_known(params, known, coords, obs_mask, intr)
        _, ext4, ba_res = bundle_adjust.adjust_points(
            projection.extrinsics_from_params(params),
            intr,
            pts3d,
            obs_all,
            fidx_all,
            pidx_all,
            mask=jnp.take(known, fidx_all, axis=0),
            weights=jnp.take(valid3d, pidx_all, axis=0).astype(jnp.float32),
            config=chain_cfg,
            init_lambda=lam,
        )
        params = projection.params_from_extrinsics(ext4[:, :3, :])
        lam = jnp.minimum(
            ba_res.final_lambda * chain_cfg.lambda_down, chain_cfg.init_lambda
        )
        return params, known, lam, n_m, n_inl

    return chain_step


def _chain_keyframe_poses(store, intrinsics, n_kf, reproj_gate: float = 4.0):
    """Marker-free keyframe poses: essential bootstrap + PnP + in-chain BA.

    The first keyframe pair is posed by the batched LO-RANSAC essential
    estimator (``geometry/ransac.py``); its unit baseline sets the global
    (monocular, up-to-scale) gauge. Every LATER keyframe is posed by PnP —
    a pose-only LM solve (``solvers.bundle_adjust.pose_only_refine``)
    against the tracks already triangulated in the global gauge — and each
    addition is followed by a masked warm-started bundle adjustment over
    everything posed so far (the standard incremental-SfM loop). The
    refinement is load-bearing, not a luxury: a compact scene gives the
    two-view bootstrap a shallow cost valley (measured: a 3-degree-off
    bootstrap pose ties the truth to within 0.01 px of Sampson residual),
    and pure PnP chaining COMPOUNDS that error into every later pose, where
    the post-hoc global BA can no longer pull the solution out of the
    wrong basin. Refining after every addition corrects the poses while
    the error is still small. All chain stages are fixed-shape (track
    capacity x keyframe capacity, observations masked), so each compiles
    exactly once regardless of keyframe count.

    PnP chaining keeps every pose in ONE gauge by construction; the previous
    per-pair essential chaining needed a depth-ratio scale handoff whose
    errors compounded multiplicatively down the chain (measured on the
    board-free test scene: per-pair scales of 0.25-0.03 where ~1.0 is true,
    collapsing later baselines ~10x).

    World frame = keyframe 0's camera (re-anchored after the final
    refinement — the in-chain BA treats the gauge as free). Reference
    analog: none — every reference pose needs the board
    (``processor.py:175-179``); this is the north-star RANSAC path inside
    ``process``.

    Returns ((F, 3, 4) extrinsics, per-step support counts: epipolar inliers
    for the bootstrap pair, PnP inlier counts after).
    """
    from meatmodeler_tpu.geometry import ransac
    from meatmodeler_tpu.solvers import bundle_adjust

    k = jnp.asarray(intrinsics, jnp.float32)
    coords = store.coords  # (T, F, 2)
    obs_mask = jnp.asarray(store.obs_mask)
    obs_mask_np = np.asarray(store.obs_mask)
    f_cap = coords.shape[1]

    # Global observation arrays for the in-chain refinement, built ONCE:
    # every observed (track, keyframe) cell, fixed shape across chain steps
    # (not-yet-posed keyframes enter masked).
    tt, ff = np.nonzero(obs_mask_np)
    obs_all = coords[jnp.asarray(tt), jnp.asarray(ff)]  # (M, 2)
    fidx_all = jnp.asarray(ff, jnp.int32)
    pidx_all = jnp.asarray(tt, jnp.int32)

    # --- bootstrap pair: essential-matrix RANSAC, |t| = 1 sets the gauge ---
    sel01 = jnp.asarray(obs_mask_np[:, 0] & obs_mask_np[:, 1])
    rvec, tvec, res = ransac.estimate_relative_pose(
        coords[:, 0], coords[:, 1], sel01, k, jax.random.PRNGKey(0)
    )
    n_inl = int(np.asarray(jnp.sum(res.inliers & sel01)))  # one fused fetch
    support = [n_inl]
    if n_inl < 8:
        raise ValueError(
            f"marker-free pose bootstrap failed: keyframe pair (0, 1) has "
            f"only {n_inl} epipolar inliers (< 8) — the video lacks "
            "trackable structure or camera motion"
        )

    params = np.zeros((f_cap, 6), np.float32)
    params[1] = np.concatenate([np.asarray(rvec), np.asarray(tvec)])
    # Placeholder for not-yet-posed keyframes: the last known pose (inert —
    # their observations are masked out of every stage below).
    params[2:] = params[1]
    known = np.zeros(f_cap, bool)
    known[:2] = True

    pose_cfg = dataclasses.replace(
        SolverConfig(), ftol=1e-8, max_iters=100
    )
    # In-chain refinement solver: moderate iteration budget per step (the
    # warm start from the previous step's solution makes each solve short).
    chain_cfg = dataclasses.replace(SolverConfig(), ftol=1e-6, max_iters=12)

    # The whole per-step computation (re-triangulate -> 2-start PnP ->
    # trimmed re-solve -> masked warm-started BA) is ONE jitted program with
    # a traced step index; the host loop only chains device handles. See
    # _make_chain_step for why (2 device syncs/step eliminated; PnP start
    # selection + trim predicate moved on device). The per-step gates and
    # support counts come back in one fused fetch after the last step, so a
    # doomed video fails with the same described errors, one step later.
    chain_step = _make_chain_step(float(reproj_gate), pose_cfg, chain_cfg)
    params_dev = jnp.asarray(params)
    known_dev = jnp.asarray(known)
    lam_dev = jnp.asarray(chain_cfg.init_lambda, jnp.float32)
    gate_handles = []
    for i in range(2, n_kf):
        params_dev, known_dev, lam_dev, n_m, n_inl_i = chain_step(
            params_dev, known_dev, lam_dev, jnp.asarray(i, jnp.int32),
            coords, obs_mask, obs_all, fidx_all, pidx_all, k,
        )
        gate_handles.append((n_m, n_inl_i))
    if gate_handles:
        n_ms, n_inls = jax.device_get(
            (
                jnp.stack([g[0] for g in gate_handles]),
                jnp.stack([g[1] for g in gate_handles]),
            )
        )
        for step_off, n_m_v in enumerate(n_ms):
            if int(n_m_v) < 6:
                raise ValueError(
                    f"marker-free PnP chaining failed at keyframe {step_off + 2}: "
                    f"only {int(n_m_v)} triangulated tracks visible (< 6) — the "
                    "video lacks persistent trackable structure across keyframes"
                )
        support.extend(max(int(x), 0) for x in n_inls)

    # Re-anchor the gauge to keyframe 0 (the refinement lets every camera
    # float): ext_i' = ext_i o ext_0^{-1}. params never leave the device.
    exts = projection.extrinsics_from_params(params_dev[:n_kf])
    r0 = exts[0, :3, :3]
    t0 = exts[0, :3, 3]
    r_new = exts[:, :3, :3] @ r0.T
    t_new = exts[:, :3, 3] - jnp.einsum("fij,j->fi", r_new, t0)
    exts = jnp.concatenate([r_new, t_new[:, :, None]], axis=2)
    return exts, support


# --------------------------------------------------------------------------
# main entry point
# --------------------------------------------------------------------------


class PreBA(NamedTuple):
    """Everything ``process`` computes before the global bundle adjustment —
    the per-video unit that ``parallel.batch.process_batch`` pads, stacks,
    and solves across a device mesh (BASELINE config 5)."""

    ext_refined: jax.Array  # (F, 3, 4) pose-BA-refined extrinsics
    intrinsics: jax.Array  # (3, 3)
    dist: jax.Array  # (5,)
    points: np.ndarray  # (P, 3) triangulated points (inliers only)
    obs: np.ndarray  # (O, 2) undistorted observations
    fidx: np.ndarray  # (O,) frame indices
    pidx: np.ndarray  # (O,) point indices
    obs_weight: np.ndarray  # (O,) inverse-octave-sigma BA weights
    point_sigma: np.ndarray  # (P,) per-point octave sigma (px at level 0)
    point_parallax: np.ndarray  # (P,) endpoint-ray parallax (deg)
    n_kf: int
    image_size: Tuple[int, int]  # (w, h) — in pass-2 working resolution
    frames_total: int
    # Marker-free reconstruction (assumed K, up-to-scale; no board plane).
    markerless: bool = False
    # Pass-2 working-resolution divisor (config.pass2_downscale, resolved):
    # image-plane quantities above are in 1/kf_scale pixel units, so
    # pixel-denominated config knobs (carve dilation) divide by it.
    kf_scale: int = 1


def _reconstruct_to_ba(video, config, known_corners, metrics, ckpt) -> PreBA:
    """PASS 1 + PASS 2 + geometry up to (but excluding) the global BA."""
    pattern = config.chessboard.pattern
    metrics.count("pass1_backend", config.pass1_backend)
    if config.pass1_backend == "host":
        # Native host scan: no device scan programs to build or compile.
        def run_pass1(markerfree=False, known=known_corners, prefetch=None):
            return _run_pass1_host(
                video, config, pattern, known, metrics, markerfree=markerfree,
                prefetch=prefetch,
            )
    else:
        init_carry, scan_chunk = _make_keyframe_scan(config)

        def run_pass1(markerfree=False, known=known_corners, prefetch=None):
            return _run_pass1(
                video, config, pattern, known, metrics, init_carry, scan_chunk,
                markerfree=markerfree, prefetch=prefetch,
            )

    # ---- PASS 1: stream chunks, select keyframes ----
    kf_stack = None
    markerless = False
    prefetch = None
    prefetch_indices = None
    if ckpt.has("keyframes"):
        data = ckpt.load("keyframes")
        # float32 enhanced greys: any rounding here would make resumed runs
        # differ from fresh ones (top-k ties in the detectors flip on
        # 0.1-level changes).
        kf_stack = jnp.asarray(data["greys"], jnp.float32)
        corners_arr = data["corners"]
        markerless = corners_arr.shape[1] == 0  # the markerfree sentinel
        kf_corners = [None] * len(corners_arr) if markerless else list(corners_arr)
        n_kf = len(kf_corners)
        frame_idx = int(data["frames_total"])
        p2s = int(data["kf_scale"]) if "kf_scale" in data else 1
        kf_indices = list(data["indices"]) if "indices" in data else []
        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes", n_kf)
    elif config.assume_markerless and known_corners is None:
        # Caller-declared board-free video: go straight to the marker-free
        # scan — no board hunt, no board-gated first pass to come up empty.
        markerless = True
        prefetch = _Pass2Prefetch(config)
        kf_frames, kf_corners, _, _, kf_indices, frame_idx, scale, p2s = (
            run_pass1(markerfree=True, known=None, prefetch=prefetch)
        )
        prefetch_indices = list(kf_indices)
        n_kf = len(kf_frames)
        metrics.count("keyframes", n_kf)
    else:
        prefetch = _Pass2Prefetch(config)
        (kf_frames, kf_corners, kf_small_dev, kf_small_host, kf_indices,
         frame_idx, scale, p2s) = run_pass1(prefetch=prefetch)
        prefetch_indices = list(kf_indices)
        with metrics.stage("board_detect"):
            # Batched post-pass detection (one device program + one readback
            # for the whole keyframe set) + sequential orientation anchoring;
            # boardless keyframes are dropped (processor.py:369-371).
            kf_frames, kf_corners, kf_indices = _resolve_board_corners(
                kf_frames, kf_corners, kf_small_dev, kf_small_host, kf_indices,
                pattern, scale, config, metrics, kf_scale=p2s,
            )
        n_kf = len(kf_frames)
        metrics.count("keyframes", n_kf)
        if n_kf < 3 and config.markerless_fallback and known_corners is None:
            # Board-free video: re-run keyframe selection without the board
            # gate; poses will bootstrap from essential-matrix RANSAC
            # (up-to-scale output). The reference busy-loops forever here
            # (processor.py:316-319).
            markerless = True
            logger.info(
                "only %d board keyframes; falling back to marker-free path", n_kf
            )
            prefetch.discard()
            prefetch = _Pass2Prefetch(config)
            kf_frames, kf_corners, _, _, kf_indices, frame_idx, scale, p2s = (
                run_pass1(markerfree=True, known=None, prefetch=prefetch)
            )
            prefetch_indices = list(kf_indices)
            n_kf = len(kf_frames)
            metrics.count("keyframes", n_kf)
    if markerless:
        metrics.count("markerless", True)
    metrics.count("kf_scale", p2s)
    # Which source frames became keyframes — ground-truth evaluation (the
    # marker-free Umeyama gate aligns per-keyframe poses) and host/device
    # selection-parity debugging both need the mapping.
    metrics.count("keyframe_indices", [int(i) for i in kf_indices])

    if n_kf < 3:
        raise ValueError(
            f"only {n_kf} keyframes"
            + (
                ""
                if markerless
                else " with a visible chessboard"
            )
            + "; need >= 3 (check the video shows the calibration target,"
            " or enough camera motion for the marker-free fallback)"
        )
    if n_kf > config.tracks.max_keyframes:
        raise ValueError(
            f"{n_kf} keyframes exceed tracks.max_keyframes="
            f"{config.tracks.max_keyframes}; raise the capacity or the "
            "keyframe threshold"
        )

    return _pass2_to_preba(
        config, metrics, ckpt, kf_stack, kf_frames if kf_stack is None else [],
        kf_corners, kf_indices, n_kf, frame_idx, p2s, markerless, prefetch,
        prefetch_indices,
    )


def _pass2_to_preba(
    config, metrics, ckpt, kf_stack, kf_frames, kf_corners, kf_indices,
    n_kf, frame_idx, p2s, markerless, prefetch=None, prefetch_indices=None,
    return_handles=False,
):
    """PASS 2 + geometry from resolved keyframes to the BA-ready problem —
    the back half of ``_reconstruct_to_ba``, split out so the multi-video
    batch fast path (``parallel.batch``) can feed it keyframes selected by
    the BATCHED device scan instead of the per-video pass-1 drivers.

    Either ``kf_stack`` (already-enhanced working-res greys) or
    ``kf_frames`` (device-resident raw keyframes to enhance here) must be
    provided."""
    pattern = config.chessboard.pattern
    orb_batch = None
    if kf_stack is None:
        # Prefetched path: the enhance + ORB minibatches were dispatched from
        # the pass-1 retain worker and have been executing behind the host
        # scan (see _Pass2Prefetch); select the rows that survived board
        # resolution. Fallback: the post-pass batched path below (identical
        # programs, identical numerics).
        pre2 = (
            prefetch.finish(len(prefetch_indices)) if prefetch is not None else None
        )
        if pre2 is not None:
            enh_all, orb_all = pre2
            pos = {int(g): i for i, g in enumerate(prefetch_indices)}
            rows = [pos[int(g)] for g in kf_indices]
            keep_all = rows == list(range(len(prefetch_indices)))
            sel = jnp.asarray(rows, jnp.int32)
            metrics.count("pass2_prefetched", True)
            with metrics.stage("pass2_preprocess"):
                kf_stack = enh_all if keep_all else enh_all[sel]
            with metrics.stage("pass2_orb"):
                orb_batch = (
                    orb_all
                    if keep_all
                    else jax.tree.map(lambda x: x[sel], orb_all)
                )
    if kf_stack is None:
        # Upload the full-res keyframe BGR frames, then the exact reference
        # preprocessing (increaseContrast + grey, processor.py:314,357) at
        # full resolution on device — in fixed minibatches so the program
        # compiles once, not once per keyframe count.
        with metrics.stage("pass2_preprocess"):
            # kf_frames are already device-resident (uploaded by the pass-1
            # resolve worker).
            mb = _ORB_MINIBATCH
            frames_p = list(kf_frames) + [kf_frames[-1]] * ((-n_kf) % mb)
            enhance = (
                _clahe_grey_batch
                if (config.pass2_enhance == "grey" or kf_frames[0].ndim == 2)
                else _enhanced_grey_batch
            )
            kf_stack = jnp.concatenate(
                [
                    enhance(jnp.stack(frames_p[i : i + mb]))
                    for i in range(0, len(frames_p), mb)
                ]
            )[:n_kf]
    if ckpt.enabled and not ckpt.has("keyframes"):
        ckpt.save(
            "keyframes",
            greys=np.asarray(kf_stack, np.float32),
            # (n_kf, 0, 2) = the markerfree sentinel for resume.
            corners=(
                np.zeros((n_kf, 0, 2), np.float32)
                if markerless
                else np.stack(kf_corners)
            ),
            frames_total=frame_idx,
            kf_scale=p2s,
            indices=np.asarray(kf_indices, np.int64),
        )

    # ---- PASS 2: batched keyframe processing ----
    if orb_batch is None:
        with metrics.stage("pass2_orb"):
            # Fixed-size minibatches: one compiled program regardless of the
            # video's keyframe count (n_kf varies per video and a vmap over
            # all of it both recompiles every time and, at 1080p, can exceed
            # HBM at compile time).
            run_orb = _make_orb_minibatch(config.orb)
            mb = _ORB_MINIBATCH
            pads = (-n_kf) % mb
            stack_p = (
                jnp.concatenate([kf_stack, kf_stack[-1:].repeat(pads, 0)])
                if pads
                else kf_stack
            )
            parts = [run_orb(stack_p[i : i + mb]) for i in range(0, len(stack_p), mb)]
            orb_batch = jax.tree.map(lambda *xs: jnp.concatenate(xs)[:n_kf], *parts)

    with metrics.stage("pass2_matching"):
        pair_matches = _run_minibatched(
            _make_match_minibatch(config.matcher),
            _ORB_MINIBATCH,
            orb_batch.descriptors[:-1],
            orb_batch.descriptors[1:],
            orb_batch.mask[:-1],
            orb_batch.mask[1:],
        )
        # Deferred readback: a metrics-only value never earns a mid-pipeline
        # device sync; it materializes
        # with the batched flush in Metrics.as_dict().
        metrics.count_async(
            "matches_per_pair",
            jnp.sum(pair_matches.mask, axis=1),
            convert=lambda v: [int(x) for x in v],
        )

    with metrics.stage("pass2_tracks"):
        # The store's keyframe axis is bucketed to 8-multiples so the tracks
        # scan and the triangulation gate compile once per size class, not
        # once per keyframe count. Padded pair rows carry mask=False — a scan step with no
        # matches writes nothing (it only pops `alive`, which finalization
        # clears anyway) — and padded frame columns never receive
        # observations, so every downstream obs_mask-gated reduction is
        # unchanged.
        fb = -(-max(n_kf, 2) // 8) * 8
        store = tracks_mod.make_store(config.tracks.max_tracks, fb)
        qi, ti, mm = pair_matches.query_idx, pair_matches.train_idx, pair_matches.mask
        xy_all, oct_all = orb_batch.xy, orb_batch.octave
        pad_pairs = fb - 1 - qi.shape[0]
        if pad_pairs:
            zrow = lambda a: jnp.concatenate(
                [a, jnp.zeros((pad_pairs,) + a.shape[1:], a.dtype)]
            )
            qi, ti, mm = zrow(qi), zrow(ti), zrow(mm)
            xy_all, oct_all = zrow(xy_all), zrow(oct_all)
        store = tracks_mod.update_tracks_scan(store, qi, ti, mm, xy_all, oct_all)
        store = tracks_mod.finalize_tracks(store)
        metrics.count_async("tracks", jnp.sum(store.used), convert=int)

    # ---- GEOMETRY ----
    h, w = kf_stack.shape[1:]
    if markerless:
        # Marker-free bootstrap: assumed pinhole K; the first pair is posed
        # by essential-matrix RANSAC, later keyframes by PnP against the
        # incrementally triangulated tracks. Output is up-to-scale.
        # markerless_focal is denominated in FULL-resolution pixels (the
        # unit a user reads off EXIF/calibration); the working grid here is
        # 1/p2s of that, so a supplied focal scales down with it. The
        # assumed prior is computed from the working w/h directly.
        focal = (
            config.markerless_focal / p2s
            if config.markerless_focal
            else 1.2 * max(int(w), int(h))
        )
        intr = jnp.asarray(
            [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
            jnp.float32,
        )
        dist_coefs = jnp.zeros(5, jnp.float32)
        with metrics.stage("pose_chain"):
            ext_refined, chain_inliers = _chain_keyframe_poses(
                store, intr, n_kf,
                reproj_gate=config.tracks.max_reproj_px / p2s,
            )
            metrics.count("pose_chain_inliers", chain_inliers)
            numerics.check_finite("pose_chain", extrinsics=ext_refined)
    else:
        with metrics.stage("corner_refine"):
            # Board corners were detected in FULL-resolution pixels; pass-2
            # geometry runs in the keyframes' (1/p2s) pixel units.
            corners = jnp.asarray(np.stack(kf_corners)) / p2s  # (F, N, 2)
            corners = _run_minibatched(
                _make_subpix_minibatch(
                    config.chessboard.subpix_window, config.chessboard.subpix_iters
                ),
                _ORB_MINIBATCH,
                kf_stack,
                corners,
            )

        with metrics.stage("calibration"):
            obj_z0 = calibration.chessboard_object_points(pattern, corners.dtype)
            # Bucketed to 8-multiples like every other pass-2 stage: padded
            # views repeat view 0 (all intermediates stay finite) and carry
            # view_mask=False, so the calibration program compiles once per
            # size class instead of once per keyframe count.
            cal_fb = -(-n_kf // 8) * 8
            if cal_fb != n_kf:
                corners_cal = jnp.concatenate(
                    [corners, jnp.tile(corners[:1], (cal_fb - n_kf, 1, 1))]
                )
                vmask = jnp.arange(cal_fb) < n_kf
            else:
                corners_cal, vmask = corners, None
            calib = calibration.calibrate(
                corners_cal,
                obj_z0,
                jnp.asarray([w, h], corners.dtype),
                num_dist=config.chessboard.calib_num_dist,
                fix_principal_point=config.chessboard.calib_fix_principal_point,
                single_focal=config.chessboard.calib_single_focal,
                view_mask=vmask,
            )
            metrics.count_async("calibration_rms_px", calib.rms, convert=float)
            numerics.check_finite("calibration", intrinsics=calib.intrinsics, dist=calib.dist)
            intr, dist_coefs = calib.intrinsics, calib.dist

        with metrics.stage("pose_estimation"):
            side = config.chessboard.side_length
            pose_stage = _make_pose_stage(side)
            und_corners, poses = _run_minibatched(
                lambda c: pose_stage(c, intr, dist_coefs, obj_z0),
                _ORB_MINIBATCH,
                corners,
            )

        with metrics.stage("pose_ba"):
            ext0 = projection.extrinsics_from_params(poses)
            # Tighter-than-global ftol: the pose-only problem is tiny (F
            # independent 6-dof solves) and everything downstream —
            # especially which marginal tracks pass the triangulation gate —
            # is sensitive to where these poses land; at the reference's
            # 1e-4 the LM stops a few percent short of the optimum at a
            # damping-path-dependent point.
            pose_cfg = dataclasses.replace(
                config.solver,
                ftol=min(config.solver.ftol, 1e-7),
                max_iters=max(config.solver.max_iters, 100),
            )
            ext_refined, pose_ba_res = bundle_adjust.adjust_pose(
                ext0,
                intr,
                und_corners.reshape(-1, 2),
                pattern=pattern,
                side_length=side,
                config=pose_cfg,
            )
            metrics.count_async("pose_ba_rmse_px", pose_ba_res.rmse, convert=float)
            numerics.check_finite("pose_ba", extrinsics=ext_refined)

    with metrics.stage("triangulation"):
        # The gate runs at the store's bucketed keyframe capacity: pad the
        # pose set with identity extrinsics (valid SO(3), so no NaNs leak
        # into the masked reductions); padded frames have no observations.
        fb = store.coords.shape[1]
        if fb != n_kf:
            ident = jnp.broadcast_to(
                jnp.eye(3, 4, dtype=ext_refined.dtype), (fb - n_kf, 3, 4)
            )
            ext_gate = jnp.concatenate([jnp.asarray(ext_refined), ident])
        else:
            ext_gate = ext_refined
        projections = projection.projection_from_extrinsic(intr, ext_gate)
        store, tri_valid, n_outlier, track_parallax = _make_triangulate_gate(
            config.tracks.triangulation,
            config.orb.scale_factor,
            config.tracks.min_parallax_deg,
            reproj_gate=config.tracks.max_reproj_px / p2s,
        )(store, ext_gate, intr, dist_coefs, projections)
        metrics.count_async("triangulated", jnp.sum(tri_valid), convert=int)
        metrics.count_async("outlier_tracks_dropped", n_outlier, convert=int)

    # Device-handle bundle for the ONE batched fetch below. The multi-video
    # batch path collects these across ALL videos and issues a single
    # ``jax.device_get`` for the whole batch instead of one per video.
    handles = _P2Handles(
        store=store,
        tri_valid=tri_valid,
        track_parallax=track_parallax,
        ext_refined=ext_refined,
        intrinsics=intr,
        dist=dist_coefs,
        n_kf=n_kf,
        frame_idx=frame_idx,
        markerless=markerless,
        p2s=p2s,
        image_size=(int(w), int(h)),
        scale_factor=float(config.orb.scale_factor),
    )
    if return_handles:
        # Multi-video batch path: the caller collects every video's handles
        # and fetches them in ONE device_get (see parallel.batch).
        return handles
    return _finish_preba(handles, jax.device_get(_p2_fetch_leaves(handles)))


class _P2Handles(NamedTuple):
    """Device handles + static metadata between pass-2 dispatch and the
    host-side PreBA assembly (the fetch boundary of ``_pass2_to_preba``)."""

    store: Any
    tri_valid: Any
    track_parallax: Any
    ext_refined: Any
    intrinsics: Any
    dist: Any
    n_kf: int
    frame_idx: int
    markerless: bool
    p2s: int
    image_size: Tuple[int, int]
    scale_factor: float


def _p2_pack_device(h: "_P2Handles", fb_common: int):
    """Device-side packing of every fetch leaf into ONE float32 buffer.

    One fetch per buffer is one round trip each, so the multi-video batch
    packs the whole store fetch — all leaves, all videos — into a single
    array (whether this beats a plain ``device_get`` on the GPU is
    unmeasured; ROADMAP 3.2).
    Keyframe axes pad to ``fb_common`` first so videos stack. float32
    carries every leaf exactly: coords/points/parallax are f32 already,
    octaves are small ints, the rest are bools."""
    s = h.store
    f32 = jnp.float32

    def pad_f(x):
        pad = fb_common - x.shape[1]
        if not pad:
            return x
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2)
        return jnp.pad(x, widths)

    return jnp.concatenate(
        [
            h.tri_valid.astype(f32),
            h.track_parallax.astype(f32),
            pad_f(s.coords).astype(f32).reshape(-1),
            pad_f(s.obs_mask).astype(f32).reshape(-1),
            s.used.astype(f32),
            s.points.astype(f32).reshape(-1),
            pad_f(s.octaves).astype(f32).reshape(-1),
            # Extras the batch's BA-problem build needs on host — packing
            # them here saves two more round trips per batch:
            jnp.pad(
                projection.params_from_extrinsics(h.ext_refined).astype(f32),
                ((0, fb_common - h.n_kf), (0, 0)),
            ).reshape(-1),
            h.intrinsics.astype(f32).reshape(-1),
        ]
    )


def _p2_unpack(flat: np.ndarray, t_cap: int, fb: int):
    """Inverse of ``_p2_pack_device`` for one video's row."""
    o = 0

    def take(n, shape, dtype=None):
        nonlocal o
        x = flat[o : o + n]
        o += n
        x = x.reshape(shape)
        return x if dtype is None else x.astype(dtype)

    tri_valid = take(t_cap, (t_cap,)) > 0.5
    parallax = take(t_cap, (t_cap,)).astype(np.float32)
    coords = take(t_cap * fb * 2, (t_cap, fb, 2)).astype(np.float32)
    obs_mask = take(t_cap * fb, (t_cap, fb)) > 0.5
    used = take(t_cap, (t_cap,)) > 0.5
    points = take(t_cap * 3, (t_cap, 3)).astype(np.float32)
    octaves = take(t_cap * fb, (t_cap, fb)).astype(np.int32)
    cams = take(fb * 6, (fb, 6)).astype(np.float32)
    intr = take(9, (3, 3)).astype(np.float32)
    return (tri_valid, parallax, coords, obs_mask, used, points, octaves), cams, intr


def _p2_fetch_leaves(h: "_P2Handles"):
    """Everything the host-side assembly needs, as one device_get payload."""
    s = h.store
    return (
        h.tri_valid, h.track_parallax,
        s.coords, s.obs_mask, s.used, s.points, s.octaves,
    )


def _finish_preba(h: "_P2Handles", fetched) -> PreBA:
    """Host-side BA-problem assembly from fetched store arrays (the numpy
    half of ``to_ba_arrays`` + the triangulation-gate filtering)."""
    (tri_valid_full, track_parallax_np,
     coords, obs_mask, used, pts, octaves) = [np.asarray(x) for x in fetched]

    n_obs_per = obs_mask.sum(1)
    keep = used & (n_obs_per >= 2)
    track_ids = np.nonzero(keep)[0]
    points = pts[track_ids]
    t_idx, f_idx = np.nonzero(obs_mask[track_ids])
    obs = coords[track_ids][t_idx, f_idx]
    obs_octave = octaves[track_ids][t_idx, f_idx].astype(np.int32)
    fidx = f_idx.astype(np.int32)
    pidx = t_idx.astype(np.int32)

    tri_valid_np = tri_valid_full[track_ids]
    obs_keep = tri_valid_np[pidx]
    obs_sigma = np.float32(h.scale_factor) ** obs_octave.astype(np.float32)
    obs_weight = (1.0 / obs_sigma)[obs_keep].astype(np.float32)
    points = points[tri_valid_np]
    # Per-point sigma for the volume gate: the track's MEAN observation
    # sigma (its typical, not worst-case, measurement precision).
    n_per = np.bincount(pidx, minlength=len(tri_valid_np))
    sum_per = np.bincount(pidx, weights=obs_sigma, minlength=len(tri_valid_np))
    sigma_mean = np.where(n_per > 0, sum_per / np.maximum(n_per, 1), np.inf)
    point_sigma = sigma_mean[tri_valid_np].astype(np.float32)
    point_parallax = track_parallax_np[track_ids][tri_valid_np].astype(np.float32)
    # Reindex after filtering.
    remap = -np.ones(len(tri_valid_np), np.int32)
    remap[np.nonzero(tri_valid_np)[0]] = np.arange(tri_valid_np.sum(), dtype=np.int32)
    obs, fidx, pidx = obs[obs_keep], fidx[obs_keep], remap[pidx[obs_keep]]

    return PreBA(
        ext_refined=h.ext_refined,
        intrinsics=h.intrinsics,
        dist=h.dist,
        points=points,
        obs=obs,
        fidx=fidx,
        pidx=pidx,
        obs_weight=obs_weight,
        point_sigma=point_sigma,
        point_parallax=point_parallax,
        n_kf=h.n_kf,
        image_size=h.image_size,
        frames_total=h.frame_idx,
        markerless=h.markerless,
        kf_scale=h.p2s,
    )



def process(
    video,
    path: Optional[str] = None,
    lk_params: Optional[dict] = None,
    feature_params: Optional[dict] = None,
    flann_params: Optional[dict] = None,
    config: PipelineConfig = DEFAULT_CONFIG,
    known_corners: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
) -> ProcessResult:
    """Video -> bundle-adjusted point cloud + volume (+ ``<path>Cloud.ply``).

    Args:
      video: path (video/.npy/.y4m) or (T, H, W[, 3]) uint8 array.
      path: output prefix; writes ``<path>Cloud.ply`` like ``processor.py:480``
        (skipped if None).
      lk_params / feature_params / flann_params: reference-compatible cv2
        param dicts (``processor.py:294-301``); folded into `config`.
        ``flann_params`` is accepted and ignored — matching is exact here.
      config: the full config tree.
      known_corners: optional (T, N, 2) ground-truth board corners per frame
        (synthetic benchmarks; skips host detection).
      checkpoint_dir: if set, per-stage artifacts persist there and a re-run
        resumes after the last completed stage (SURVEY.md §5.4 — the
        reference has no checkpointing of any kind).

    Returns:
      ProcessResult — including the point cloud the reference promised but
      never returned (``processor.py:303``). For board-free videos (with
      ``config.markerless_fallback``) the reconstruction is **up-to-scale**
      (monocular gauge, assumed K) and ``metrics["counters"]["markerless"]``
      is set; the reference busy-loops forever on such input
      (``processor.py:316-319``).
    """
    from meatmodeler_tpu.utils.checkpoint import StageCheckpointer
    from meatmodeler_tpu.utils.profiling import profile_run

    del flann_params  # exact matmul matching needs no FLANN tuning
    config = _config_from_param_dicts(config, lk_params, feature_params)
    metrics = Metrics()
    ckpt = StageCheckpointer(checkpoint_dir)

    with profile_run():  # MEATMODELER_PROFILE=<dir> captures an XProf trace
        pre = _reconstruct_to_ba(video, config, known_corners, metrics, ckpt)
        return _solve_and_finish(pre, config, metrics, ckpt, path)


def _volume_confidence(arc_deg: float, elong: float, n_item: int, config) -> Dict[str, Any]:
    """The volume-estimate regime check shared by ``process`` and
    ``parallel.batch.process_batch``: LOW confidence
    when the (view arc, item elongation) pair sits in the estimator's
    validated weak regime, or when the item cloud is too sparse for the
    trimmed support to read the surface. Thresholds in VolumeConfig."""
    vc = config.volume
    low = (
        n_item >= 8
        and arc_deg < vc.confidence_min_arc_deg
        and elong > vc.confidence_max_elongation
    )
    reason = ""
    if low:
        reason = (
            f"view arc {arc_deg:.0f} deg < {vc.confidence_min_arc_deg:.0f} and "
            f"item elongation {elong:.2f} > {vc.confidence_max_elongation:.2f}: "
            "the symmetric-completion hull cannot observe the item's far "
            "long-axis extent from this arc (validated weak case: ~+40%)"
        )
    elif n_item < vc.confidence_min_item_points:
        # No lower bound on n_item: an (near-)empty item cloud is the LEAST
        # reliable outcome of all (the volume comes out NaN below 8 points)
        # and must carry the flag too, not dodge it.
        # Sparse-cloud regime: the trimmed support needs a dense sampling of
        # the seen surface; a few-hundred-point item (short clip, few
        # keyframes) underreads it badly (measured: 60-frame 1080p batch
        # clips with ~300-point clouds underread 55-71% where the 300-frame
        # clip of the same scene reads -14%).
        low = True
        reason = (
            f"item cloud has only {n_item} points "
            f"(< {vc.confidence_min_item_points}): the trimmed support "
            "underreads a sparsely sampled surface — use a longer clip or "
            "denser features"
        )
    return {
        "low_confidence": bool(low),
        "view_arc_deg": round(arc_deg, 2),
        "elongation": round(elong, 3),
        "reason": reason,
        "n_item_points": n_item,
    }


def _solve_and_finish(
    pre: PreBA,
    config: PipelineConfig,
    metrics: Metrics,
    ckpt,
    path: Optional[str],
) -> ProcessResult:
    """Global BA + volume + PLY from a PreBA — the back half of ``process``
    (split out so ``parallel.pipelined`` can run it as its own pipeline
    stage on a different device)."""
    n_kf = pre.n_kf
    w, h = pre.image_size

    with metrics.stage("bundle_adjustment"):
        if config.incremental_ba:
            # Online refinement — the reference's intended incremental design
            # (commented out at processor.py:395-408): after each keyframe,
            # re-solve the BA on the observation prefix. One compiled masked
            # solve is reused for every prefix (shapes never change); the
            # final prefix IS the global problem.
            # Warm-started: each prefix starts from the previous prefix's
            # refined parameters AND its exit damping — prefix k+1 differs
            # from k by one keyframe's observations, so the previous solution
            # is a near-optimum and the LM converges in a couple of
            # iterations instead of repeating the full damping walk.
            ext_cur, pts_cur = pre.ext_refined, pre.points
            fidx_j = jnp.asarray(pre.fidx)
            rmse_steps = []
            lam_cur = None
            iters_total = 0
            for k in range(3, n_kf + 1):
                pts_cur, ext4, ba_res = bundle_adjust.adjust_points(
                    ext_cur,
                    pre.intrinsics,
                    pts_cur,
                    pre.obs,
                    pre.fidx,
                    pre.pidx,
                    mask=fidx_j < k,
                    weights=pre.obs_weight,
                    config=config.solver,
                    init_lambda=lam_cur,
                )
                ext_cur = ext4[:, :3, :]
                # Carry the exit damping down one notch, CAPPED at the cold
                # init value: near convergence LM walks lambda up through
                # rejected steps, and an uncapped carry makes the next
                # prefix's first (tiny) step satisfy ftol immediately —
                # measured: premature stop at 10+ px RMSE at ftol=1e-6
                # without the cap, vs 40% fewer total iterations at equal
                # RMSE with it (tests/test_bundle_adjust.py).
                lam_cur = min(
                    float(ba_res.final_lambda) * config.solver.lambda_down,
                    config.solver.init_lambda,
                )
                rmse_steps.append(float(ba_res.rmse))
                iters_total += int(ba_res.iterations)
            new_pts, new_ext = pts_cur, ext4
            metrics.count("ba_rmse_px_steps", rmse_steps)
            metrics.count("ba_iterations_total", iters_total)
        else:
            new_pts, new_ext, ba_res = bundle_adjust.adjust_points(
                pre.ext_refined,
                pre.intrinsics,
                pre.points,
                pre.obs,
                pre.fidx,
                pre.pidx,
                weights=pre.obs_weight,
                config=config.solver,
            )
        metrics.count_async("ba_rmse_px", ba_res.rmse, convert=float)
        metrics.count_async("ba_iterations", ba_res.iterations, convert=int)
        numerics.check_finite("bundle_adjustment", points=new_pts, extrinsics=new_ext)
        metrics.count("points", int(new_pts.shape[0]))  # shape only — no sync
        if ckpt.enabled:
            ckpt.save(
                "cloud",
                points=np.asarray(new_pts),
                extrinsics=np.asarray(new_ext),
                intrinsics=np.asarray(pre.intrinsics),
                distortion=np.asarray(pre.dist),
                rmse=float(ba_res.rmse),
            )

    with metrics.stage("volume"):
        # Dispatch only — the (4,) fused result is fetched once below, after
        # the PLY write has overlapped the volume program's device time.
        vol_fused_j = _estimate_volume(
            jnp.asarray(new_pts), pre.intrinsics, jnp.asarray(new_ext), n_kf, (w, h), config,
            point_sigma=pre.point_sigma,
            point_parallax=pre.point_parallax,
            use_plane=not pre.markerless,
            kf_scale=pre.kf_scale,
            rmse=ba_res.rmse,
        )

    ply_path = None
    # ONE batched fetch of every result buffer (device_get issues all copies
    # before blocking): points, extrinsics, intrinsics, distortion. These are
    # ready as soon as BA finishes, so the transfer overlaps the still-queued
    # volume program's device time.
    new_pts_np, new_ext_np, intr_np, dist_np = jax.device_get(
        (new_pts, new_ext, pre.intrinsics, pre.dist)
    )
    if path is not None:
        with metrics.stage("ply_export"):
            ply_path = ply_mod.write_ply(str(path) + "Cloud.ply", new_pts_np)

    # ONE fused readback for everything still on device: hull volume, carve
    # volume, item count, solver RMSE (each separate fetch is a round trip).
    fused = np.asarray(vol_fused_j)
    n_item = int(fused[2])
    if n_item >= 8:
        vol_hull, vol_carve = float(fused[0]), float(fused[1])
    else:
        vol_hull = vol_carve = float("nan")
    metrics.count("item_points", n_item)
    metrics.count("volume_hull", vol_hull)
    metrics.count("volume_carved", vol_carve)

    # Volume-confidence regime check: the hull's
    # documented weak case is an elongated item observed from a narrow view
    # arc (+~40% overshoot — the symmetric completion cannot know the
    # unseen long-axis extent). Surface the predictors and a LOW flag so
    # callers know when the estimate is in that regime instead of silently
    # trusting it; thresholds in VolumeConfig, gated against
    # tools/volume_validation.py's scene spread.
    volume_confidence = _volume_confidence(
        float(fused[4]), float(fused[5]), n_item, config
    )
    metrics.count("volume_low_confidence", volume_confidence["low_confidence"])
    metrics.count("volume_view_arc_deg", volume_confidence["view_arc_deg"])
    metrics.count("volume_elongation", volume_confidence["elongation"])

    return ProcessResult(
        points=new_pts_np,
        extrinsics=new_ext_np,
        intrinsics=intr_np,
        distortion=dist_np,
        volume=vol_hull,
        volume_carved=vol_carve,
        ply_path=ply_path,
        reprojection_rmse=float(fused[3]),
        metrics=metrics.as_dict(),
        volume_confidence=volume_confidence,
    )


def _estimate_volume(
    pts_j, intrinsics, ext4, n_kf, image_size, config, point_sigma=None,
    point_parallax=None, use_plane=True, kf_scale=1, rmse=None,
):
    """Hull + carved volume of the item points — DISPATCH ONLY.

    Returns a (6,) device array [hull, carve, n_item, rmse, view_arc_deg,
    elongation] (``rmse`` is an unrelated scalar hitching a ride on the
    caller's single fused readback; 0 when not supplied; the last two are
    the volume-confidence predictors — see ``_view_regime``). The caller
    applies the too-few-points NaN rule after fetching.

    ``point_sigma``: per-point positional uncertainty (octave sigma). The
    hull/carve estimators are set entirely by extreme points, so
    coarse-octave points (uncertainty of several px -> large depth noise)
    are excluded from the volume point set — they still served pose/BA.
    ``point_parallax``: per-point endpoint-ray parallax (deg); depth noise
    scales as 1/parallax, so low-parallax points are likewise excluded
    (config.volume.min_parallax_deg — stabilizes the hull against the
    marginal tracks whose inclusion flips run-to-run).
    ``use_plane=False``: marker-free world frame, no board plane to gate on
    (the volume is then in the arbitrary monocular gauge's units^3).

    Shape-bucketed: points pad to 1024-multiples (masked out) and keyframes
    to 8-multiples (``proj_mask`` False), so the ~15 s volume compile is
    reused across videos of the same size class instead of re-paid for every
    distinct (P, F) — the same discipline as the BA solver's
    ``_pad_problem`` (solvers/bundle_adjust.py).
    """
    w, h = image_size
    p_real = int(pts_j.shape[0])
    pb = max(-(-p_real // 1024) * 1024, 1024)
    f_real = int(n_kf)
    fb = -(-f_real // 8) * 8
    if pb != p_real:
        pts_j = jnp.pad(jnp.asarray(pts_j), ((0, pb - p_real), (0, 0)))
        if point_sigma is not None:
            point_sigma = np.pad(
                np.asarray(point_sigma, np.float32), (0, pb - p_real),
                constant_values=np.inf,  # fails the sigma gate
            )
        if point_parallax is not None:
            point_parallax = np.pad(
                np.asarray(point_parallax, np.float32), (0, pb - p_real)
            )  # 0 parallax fails the parallax gate
    if fb != f_real:
        ext4 = jnp.pad(jnp.asarray(ext4), ((0, fb - f_real), (0, 0), (0, 0)))
    valid = jnp.arange(pb) < p_real
    proj_mask = jnp.arange(fb) < f_real
    sig_j = (
        jnp.asarray(point_sigma) if point_sigma is not None
        else jnp.zeros(pb, jnp.float32)
    )
    par_j = (
        jnp.asarray(point_parallax) if point_parallax is not None
        else jnp.zeros(pb, jnp.float32)
    )
    return _volume_core(
        pts_j, valid, proj_mask, jnp.asarray(ext4), jnp.asarray(intrinsics),
        sig_j, par_j,
        jnp.zeros((), jnp.float32) if rmse is None else jnp.asarray(rmse),
        config=config, image_size=(w, h), kf_scale=kf_scale,
        use_plane=use_plane,
        use_sigma=point_sigma is not None and config.volume.max_point_sigma > 0,
        use_par=point_parallax is not None and config.volume.min_parallax_deg > 0,
    )


def _volume_core(
    pts_j, valid, proj_mask, ext4, intrinsics, point_sigma, point_parallax,
    rmse, *, config, image_size, kf_scale, use_plane, use_sigma, use_par,
):
    """The jnp body of ``_estimate_volume`` after padding — separated so
    the multi-video batch can run it ``vmap``ped over a stacked batch as ONE
    device program (eight sequential per-video volume programs were ~4 s of
    the warm batch; see ``parallel.batch._estimate_volume_batch``)."""
    w, h = image_size
    pmask = valid
    if use_sigma:
        precise = valid & (point_sigma <= config.volume.max_point_sigma)
        # Fall back to all points if the precise subset is too thin.
        pmask = jnp.where(jnp.sum(precise) >= 32, precise, pmask)
    if use_par:
        certain = pmask & (point_parallax >= config.volume.min_parallax_deg)
        pmask = jnp.where(jnp.sum(certain) >= 32, certain, pmask)
    item_mask = volume_mod.split_item_points(pts_j, pmask, use_plane=use_plane)
    # The hull's trimmed support uses the SAME gated item cloud as the carve
    # silhouettes. (Round 3 shipped an ungated support with a deep trim=9 —
    # both choices turned out to be compensations for an on-device item
    # split corrupted by reduced-precision matmuls, see split_item_points.
    # Re-measured on clean numerics across the tools/volume_validation.py
    # scene spread, gated support + trim=5 is the worst-case optimum: the
    # sigma/parallax gates remove exactly the low-parallax depth smears
    # that slip past the silhouette pruning when the view arc is narrow —
    # rays near-parallel across views keep a smear inside every
    # silhouette, so the membership vote cannot see it.)
    support_mask = item_mask
    proj_new = projection.projection_from_extrinsic(intrinsics, ext4[:, :3, :])
    # One carve serves both estimators: the hull is (robust symmetric
    # completion of the seen surface) ∩ (visual hull) — see
    # hull_and_carved_volume for why neither a sparse-point hull nor a
    # silhouette carve alone can estimate volume from a one-sided view
    # wedge. Dispatched UNCONDITIONALLY (degenerate masks produce NaNs,
    # discarded below) so the host reads back everything in ONE sync.
    vol_hull_j, vol_carve_j = volume_mod.hull_and_carved_volume(
        pts_j,
        item_mask,
        proj_new,
        proj_mask,
        image_size=(w, h),
        resolution=config.volume.voxel_resolution,
        num_directions=config.volume.hull_directions,
        trim=config.volume.hull_trim,
        # carve_dilation is denominated in FULL-resolution pixels;
        # the projections here are in working-res (1/kf_scale) units.
        # The silhouette grid step likewise shrinks so its full-res-
        # equivalent granularity stays constant.
        dilation=max(1, round(config.volume.carve_dilation / kf_scale)),
        grid_step=max(1, 4 // kf_scale),
        close_frac=config.volume.carve_close_frac,
        vote_frac=config.volume.carve_vote_frac,
        support_mask=support_mask,
        trim_ref=config.volume.hull_trim_ref,
    )
    return jnp.concatenate(
        [
            jnp.stack(
                [
                    vol_hull_j.astype(jnp.float32),
                    vol_carve_j.astype(jnp.float32),
                    jnp.sum(item_mask).astype(jnp.float32),
                    rmse.astype(jnp.float32),
                ]
            ),
            _view_regime(ext4, proj_mask, pts_j, item_mask).astype(jnp.float32),
        ]
    )


@functools.lru_cache(maxsize=8)
def _make_volume_batch(config, image_size, kf_scale, use_plane):
    """jit(vmap(_volume_core)) for a uniform video batch — ONE program for
    every video's hull+carve+regime instead of V sequential dispatches."""
    core = functools.partial(
        _volume_core,
        config=config, image_size=image_size, kf_scale=kf_scale,
        use_plane=use_plane, use_sigma=config.volume.max_point_sigma > 0,
        use_par=config.volume.min_parallax_deg > 0,
    )
    return jax.jit(jax.vmap(core))


@jax.jit
@matmul_highp
def _view_regime(ext4, proj_mask, points, item_mask):
    """(2,) [view_arc_deg, elongation] — the volume-confidence predictors.

    The hull estimator's documented weak case (config.py VolumeConfig
    notes; tools/volume_validation.py) is an ELONGATED item seen from a
    NARROW view arc: the symmetric completion cannot know the unseen
    long-axis extent and overshoots by ~+40%. Both predictors are cheap
    device reductions that ride the caller's single fused readback:

      * view_arc_deg — the maximum pairwise angle between the active
        keyframe cameras' viewing directions (camera center -> item
        centroid). A full turntable orbit reads near 180; a one-sided
        wedge reads its arc.
      * elongation — sqrt of the ratio of the item cloud's largest to
        middle covariance eigenvalue (1.0 = isotropic in its two longest
        axes; the weak-case scenes read ~2+).
    """
    n_item = jnp.maximum(jnp.sum(item_mask), 1)
    pts_f = points.astype(jnp.float32)
    centroid = jnp.sum(jnp.where(item_mask[:, None], pts_f, 0.0), axis=0) / n_item

    r = ext4[:, :3, :3]
    t = ext4[:, :3, 3]
    centers = -jnp.einsum("fij,fi->fj", r, t)  # -R^T t
    d = centers - centroid[None, :]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    cosang = jnp.clip(d @ d.T, -1.0, 1.0)
    pair_ok = proj_mask[:, None] & proj_mask[None, :]
    arc = jnp.max(jnp.where(pair_ok, jnp.arccos(cosang), 0.0))
    arc_deg = arc * (180.0 / jnp.pi)

    x = jnp.where(item_mask[:, None], pts_f - centroid[None, :], 0.0)
    cov = (x.T @ x) / n_item
    eig = jnp.linalg.eigvalsh(cov)  # ascending
    elong = jnp.sqrt(eig[2] / jnp.maximum(eig[1], 1e-12))
    return jnp.stack([arc_deg, elong])
