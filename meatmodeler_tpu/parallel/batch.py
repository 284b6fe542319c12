"""Multi-video reconstruction with mesh-sharded bundle adjustment.

BASELINE config 5: "batched multi-object pipeline: concurrent videos sharded
across the devices with per-device BA solves". The reference is strictly one video
per process with zero parallelism (SURVEY.md §2.5); here ``process_batch``
reconstructs a batch of videos and runs every video's Schur BA solve
concurrently — one per mesh ``data`` core via ``shard_map``
(``sharded.solve_ba_batch``), with NO cross-device communication (the solves
are independent).

The host-driven phases (video decode, keyframe selection, board detection)
are inherently per-video and run sequentially; all device-heavy geometry
(BA, volume) is batched. Problems are padded to common static capacities so
one compiled program serves every video.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu.geometry import projection
from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu.io import ply as ply_mod
from meatmodeler_tpu.ops import chessboard
from meatmodeler_tpu.parallel import sharded
from meatmodeler_tpu import pipeline as _pl
from meatmodeler_tpu.pipeline import (
    _volume_confidence,
    ProcessResult,
    _estimate_volume,
    _reconstruct_to_ba,
)
from meatmodeler_tpu.solvers import bundle_adjust
from meatmodeler_tpu.utils import Metrics
from meatmodeler_tpu.utils.checkpoint import StageCheckpointer

__all__ = ["process_batch"]


def _pad_to(arr: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def process_batch(
    videos: Sequence,
    config: PipelineConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    paths: Optional[Sequence[Optional[str]]] = None,
    known_corners: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> List[ProcessResult]:
    """Reconstruct several videos with their BA solves sharded over a mesh.

    Args:
      videos: sequence of video sources (paths or (T, H, W, 3) uint8 arrays).
      config: shared config tree.
      mesh: a ('data', 'model') Mesh; the video batch shards over 'data'
        (``sharded.make_mesh()``). None solves the batch on one device
        (still a single compiled vmap over videos).
      paths: optional per-video output prefixes (``<path>Cloud.ply``).
      known_corners: optional per-video ground-truth board corners.

    Returns:
      One ProcessResult per video, in input order.
    """
    n_videos = len(videos)
    paths = paths if paths is not None else [None] * n_videos
    known_corners = (
        known_corners if known_corners is not None else [None] * n_videos
    )

    from meatmodeler_tpu.utils.profiling import profile_run

    with profile_run():  # MEATMODELER_PROFILE=<dir> captures the whole batch
        return _process_batch_inner(videos, config, mesh, paths, known_corners)


def _batch_prepass(videos, config, known_corners, metrics_list):
    """Batched pass 1 for uniform in-memory clips: decimate on host, ONE
    upload + ONE vmapped device scan + batched board detection for the
    whole batch (see ``pipeline._make_batch_scan`` for why — with one host
    core the per-video C++ scans are strictly serial and dominate the warm
    batch while the device idles).

    Returns a per-video list of either kwargs-dicts for
    ``pipeline._pass2_to_preba`` or ``None`` (that video needs the full
    per-video driver: non-uniform input, no board, too few keyframes);
    returns ``None`` outright when the batch shape doesn't qualify.
    """
    if config.assume_markerless or config.pass2_enhance != "grey":
        return None
    clips = []
    for v in videos:
        if not (
            isinstance(v, np.ndarray) and v.ndim == 4 and v.dtype == np.uint8
        ):
            return None
        clips.append(v)
    if len({c.shape for c in clips}) != 1:
        return None
    t, h, w = clips[0].shape[:3]
    if t < 2:
        return None
    min_dim = min(h, w)
    scale = config.pass1_downscale or (
        4 if min_dim >= 1060 else 2 if min_dim >= 720 else 1
    )
    p2s = config.pass2_downscale or (2 if min_dim >= 1060 else 1)
    pattern = config.chessboard.pattern

    from meatmodeler_tpu.io.native_pass1 import HostPass1Scanner, host_pass1_available

    cb = config.chessboard
    device_fits = (
        pattern[0] * pattern[1] <= cb.detect_candidates
        and cb.detector in ("device", "auto")
    )
    use_cpp = host_pass1_available()

    # Interleaved per-video prepass: decimate + C++ scan video vi on the
    # host, then immediately DISPATCH its keyframes' board detection and
    # pass-2 keyframe upload (both async device work) before scanning video
    # vi+1 — the device detects boards for video vi while the host CPU
    # scans vi+1, and ONE coalesced readback at the end collects every
    # video's results. (The scalar C++ scan is ~5x cheaper than the device
    # scan for this role — the device scan's per-point LK gathers serialize
    # inside the compiled step, and vmapping videos multiplies the chain.)
    smalls_list, kf_idx_all, enh_small_rows = [], [], []
    board_handles = [None] * len(clips)
    greys2_dev_all = [None] * len(clips)
    prefetch_all = [None] * len(clips)
    # The prefetch minibatches gate on the pass-2 warmup event (compile
    # serialization); the per-video pass-1 drivers normally start that
    # warmup thread — the batch prepass replaces them, so it must too.
    import threading

    threading.Thread(
        target=_pl._warm_pass2,
        args=(
            config,
            (h // p2s, w // p2s),
            (h // scale, w // scale),
            tuple(pattern),
        ),
        daemon=True,
    ).start()
    if not use_cpp:
        smalls = np.stack(
            [native_ops.bgr_to_grey_down(c, scale) for c in clips]
        )
        flags_dev, enh_all = _pl._make_batch_scan(config)(
            jnp.asarray(smalls), width_scale=scale
        )
        flags_all = np.asarray(flags_dev)  # ONE sync for the batch's pass 1
    for vi, clip in enumerate(clips):
        if use_cpp:
            small = native_ops.bgr_to_grey_down(clip, scale)
            scanner = HostPass1Scanner(
                config, small.shape[1], small.shape[2], full_width=w
            )
            f, enh = scanner.scan(small, bootstrap_at=0)
            flags = f[1:]
        else:
            small = smalls[vi]
            flags = flags_all[vi]
            enh = None
        smalls_list.append(small)
        kf_idx = [0] + [int(i) + 1 for i in np.nonzero(flags)[0]]
        if len(kf_idx) > config.tracks.max_keyframes:
            raise ValueError(
                f"{len(kf_idx)} keyframes exceed tracks.max_keyframes="
                f"{config.tracks.max_keyframes}; raise the capacity or the "
                "keyframe threshold"
            )
        kf_idx_all.append(kf_idx)
        if enh is not None:
            enh_small = np.clip(
                np.round(enh[kf_idx]), 0, 255
            ).astype(np.uint8)
        else:
            enh_small = enh_all[vi, jnp.asarray(kf_idx)]
        enh_small_rows.append(enh_small)
        # Async device dispatches for THIS video while the next one scans:
        if known_corners[vi] is None and device_fits:
            enh_small_dev = jax.device_put(np.asarray(enh_small)) if enh is not None else enh_small
            enh_small_rows[-1] = enh_small_dev
            board_handles[vi] = _pl._detect_board_device_dispatch(
                [enh_small_dev[i] for i in range(len(kf_idx))], pattern, cb
            )
        greys2_dev_all[vi] = jax.device_put(
            native_ops.bgr_to_grey_down(np.ascontiguousarray(clip[kf_idx]), p2s)
        )
        # Prefetch pass-2 enhance+ORB for THIS video's keyframes too — the
        # same overlap trick the single-video host scan uses: ORB is the
        # batch's single largest device cost (~4.2 s for 8x11 keyframes)
        # and executes here behind the remaining videos' C++ scans.
        pf = _pl._Pass2Prefetch(config)
        for i in range(len(kf_idx)):
            pf.add(greys2_dev_all[vi][i])
        prefetch_all[vi] = pf

    # ONE coalesced readback for every video's board detection.
    dev_results_all = [None] * len(clips)
    pend = [vi for vi in range(len(clips)) if board_handles[vi] is not None]
    if pend:
        fused_all = jax.device_get(
            jnp.concatenate([board_handles[vi] for vi in pend])
        )
        off = 0
        for vi in pend:
            n_pad = int(board_handles[vi].shape[0])
            cand = _pl._detect_board_finish(
                fused_all[off : off + n_pad], len(kf_idx_all[vi]), pattern,
                scale,
            )
            off += n_pad
            dev_results_all[vi] = dict(enumerate(cand))

    out = []
    for vi, clip in enumerate(clips):
        metrics = metrics_list[vi]
        kf_idx = kf_idx_all[vi]
        metrics.count("frames_total", t)
        metrics.count("keyframes_selected", len(kf_idx))
        # Pass-2 keyframes were decimated + uploaded inside the scan loop.
        greys2_dev = greys2_dev_all[vi]
        kf_frames = [greys2_dev[i] for i in range(len(kf_idx))]

        known = known_corners[vi]
        if known is not None:
            kf_corners = [
                chessboard.canonicalize_corners(
                    np.asarray(known[g], np.float32), pattern
                )
                for g in kf_idx
            ]
            kept_frames, kept_corners, kept_idx = kf_frames, kf_corners, kf_idx
        else:
            with metrics.stage("board_detect"):
                kept_frames, kept_corners, kept_idx = _pl._resolve_board_corners(
                    kf_frames,
                    [None] * len(kf_idx),
                    [enh_small_rows[vi][i] for i in range(len(kf_idx))],
                    [smalls_list[vi][g] for g in kf_idx],
                    kf_idx,
                    pattern,
                    scale,
                    config,
                    metrics,
                    kf_scale=p2s,
                    dev_results=dev_results_all[vi],
                )
        if len(kept_frames) < 3:
            if prefetch_all[vi] is not None:
                prefetch_all[vi].discard()
            out.append(None)  # board-free/starved: full per-video driver
            continue
        metrics.count("keyframes", len(kept_frames))
        metrics.count("kf_scale", p2s)
        metrics.count("keyframe_indices", [int(i) for i in kept_idx])
        metrics.count("batch_fast_prepass", True)
        out.append(
            dict(
                kf_stack=None,
                kf_frames=kept_frames,
                kf_corners=kept_corners,
                kf_indices=kept_idx,
                n_kf=len(kept_frames),
                frame_idx=t,
                p2s=p2s,
                markerless=False,
                prefetch=prefetch_all[vi],
                prefetch_indices=kf_idx,
            )
        )
    return out


def _process_batch_inner(videos, config, mesh, paths, known_corners):
    import os as _os
    import time as _time

    _dbg = _os.environ.get("MEATMODELER_BATCH_DEBUG") == "1"
    _t0 = _time.perf_counter()

    def _mark(label):
        nonlocal _t0
        if _dbg:
            now = _time.perf_counter()
            print(f"[batch] {label}: {now - _t0:.2f}s", flush=True)
            _t0 = now

    n_videos = len(videos)
    # ---- per-video host-driven phases (decode, keyframes, features) ----
    # The fast prepass batches pass 1 (decimate -> ONE device scan -> board
    # resolution) across the whole video batch; two workers then overlap
    # video i+1's remaining host glue with video i's device-bound pass-2
    # stages; more workers only add contention since a single chip
    # serializes the device programs anyway. Videos the prepass cannot
    # serve (non-uniform shapes, boardless, markerless) run the full
    # per-video driver. Results stay in input order.
    from concurrent.futures import ThreadPoolExecutor

    metrics_list = [Metrics() for _ in range(n_videos)]
    prepped = _batch_prepass(videos, config, known_corners, metrics_list)
    _mark("prepass")

    def reconstruct(i):
        if prepped is not None and prepped[i] is not None:
            # Dispatch-only: device handles come back; the store fetch for
            # EVERY video below rides one batched device_get instead of one
            # fetch per video.
            return _pl._pass2_to_preba(
                config, metrics_list[i], StageCheckpointer(None),
                return_handles=True, **prepped[i]
            )
        return _reconstruct_to_ba(
            videos[i], config, known_corners[i], metrics_list[i],
            StageCheckpointer(None),
        )

    with ThreadPoolExecutor(max_workers=min(2, max(n_videos, 1))) as pool:
        pres = list(pool.map(reconstruct, range(n_videos)))
    _mark("pass2 dispatch")
    cams_cache, intr_cache = {}, {}
    handle_rows = [
        i for i, p in enumerate(pres) if isinstance(p, _pl._P2Handles)
    ]
    if handle_rows:
        # Pack EVERY leaf of EVERY video into ONE device buffer and fetch it
        # with a single round trip (keyframe axes pad to the widest video's
        # bucket so the rows stack).
        fb_common = max(
            pres[i].store.coords.shape[1] for i in handle_rows
        )
        packed = jnp.stack(
            [_pl._p2_pack_device(pres[i], fb_common) for i in handle_rows]
        )
        packed_np = jax.device_get(packed)
        t_cap = int(pres[handle_rows[0]].store.coords.shape[0])
        for row, i in enumerate(handle_rows):
            leaves7, cams, intr = _pl._p2_unpack(
                packed_np[row], t_cap, fb_common
            )
            n_kf_i = pres[i].n_kf
            cams_cache[i] = cams[:n_kf_i]
            intr_cache[i] = intr
            pres[i] = _pl._finish_preba(pres[i], leaves7)
    _mark("preba fetch+finish")

    # ---- pad every video's BA problem to shared static capacities ----
    f_max = max(p.n_kf for p in pres)
    p_max = max(len(p.points) for p in pres)
    o_max = max(len(p.obs) for p in pres)

    # Camera params + intrinsics came packed with the store fetch for fast-
    # path videos; legacy-path videos fetch theirs in one batched call.
    legacy_rows = [i for i in range(n_videos) if i not in cams_cache]
    if legacy_rows:
        cams_leg, intr_leg = jax.device_get(
            (
                [
                    projection.params_from_extrinsics(pres[i].ext_refined)
                    for i in legacy_rows
                ],
                [pres[i].intrinsics for i in legacy_rows],
            )
        )
        for i, c, k in zip(legacy_rows, cams_leg, intr_leg):
            cams_cache[i] = np.asarray(c)
            intr_cache[i] = np.asarray(k)
    cams_np = [cams_cache[i] for i in range(n_videos)]
    intr_np_list = [intr_cache[i] for i in range(n_videos)]

    def problem(pre, cams, intr) -> bundle_adjust.BAProblem:
        # HOST-side numpy fields: the batch stacks every video's problem on
        # host and uploads ONE array per field below (the per-video
        # jnp.asarray form paid 8 fields x V small uploads).
        n_obs = len(pre.obs)
        return bundle_adjust.BAProblem(
            cam_params=_pad_to(np.asarray(cams, np.float32), f_max),
            points=_pad_to(np.asarray(pre.points, np.float32), p_max),
            intrinsics=np.asarray(intr, np.float32),
            obs=_pad_to(np.asarray(pre.obs, np.float32), o_max),
            frame_idx=_pad_to(np.asarray(pre.fidx, np.int32), o_max),
            point_idx=_pad_to(np.asarray(pre.pidx, np.int32), o_max),
            mask=np.arange(o_max) < n_obs,
            weight=_pad_to(np.asarray(pre.obs_weight, np.float32), o_max),
        )

    problems = [
        problem(p, c, k) for p, c, k in zip(pres, cams_np, intr_np_list)
    ]
    # The data axis must divide the batch: pad with copies of the last
    # problem (their results are discarded).
    n_solve = n_videos
    if mesh is not None:
        data = mesh.shape["data"]
        while n_solve % data:
            problems.append(problems[-1])
            n_solve += 1
    batched = jax.tree.map(
        lambda *xs: jnp.asarray(np.stack(xs)), *problems
    )

    _mark("problem build")
    # ---- per-core independent Schur solves ----
    if mesh is not None:
        result = sharded.solve_ba_batch(mesh, batched, config=config.solver)
    else:
        result = jax.vmap(
            lambda pr: bundle_adjust.solve_ba(pr, config=config.solver)
        )(batched)

    _mark("solve dispatch")
    # ---- unpack, volume, PLY per video ----
    # Dispatch every video's volume program FIRST (device arrays in, no
    # forced syncs), then fetch everything the host loop needs in TWO
    # device_get batches instead of a round trip per video per readback.
    ext4_dev = [
        projection.extrinsics_from_params(
            result.cam_params[i, : pres[i].n_kf], homogeneous=True
        )
        for i in range(n_videos)
    ]
    uniform = (
        len({p.image_size for p in pres}) == 1
        and len({p.kf_scale for p in pres}) == 1
        and not any(p.markerless for p in pres)
    )
    if uniform:
        # ONE vmapped volume program for the whole batch (eight sequential
        # per-video hull+carve dispatches were ~4 s of the warm batch).
        p_max2 = result.points.shape[1]
        pb = max(-(-p_max2 // 1024) * 1024, 1024)
        fb = -(-max(p.n_kf for p in pres) // 8) * 8
        pts_b = jnp.pad(
            result.points[:n_videos], ((0, 0), (0, pb - p_max2), (0, 0))
        )
        ext_b = jnp.stack(
            [
                jnp.pad(e, ((0, fb - e.shape[0]), (0, 0), (0, 0)))
                for e in ext4_dev
            ]
        )
        valid_b = jnp.asarray(
            np.arange(pb)[None, :]
            < np.asarray([len(p.points) for p in pres])[:, None]
        )
        pmask_b = jnp.asarray(
            np.arange(fb)[None, :]
            < np.asarray([p.n_kf for p in pres])[:, None]
        )
        sig_b = jnp.asarray(
            np.stack(
                [
                    np.pad(
                        np.asarray(p.point_sigma, np.float32),
                        (0, pb - len(p.point_sigma)),
                        constant_values=np.inf,
                    )
                    for p in pres
                ]
            )
        )
        par_b = jnp.asarray(
            np.stack(
                [
                    np.pad(
                        np.asarray(p.point_parallax, np.float32),
                        (0, pb - len(p.point_parallax)),
                    )
                    for p in pres
                ]
            )
        )
        intr_b = jnp.asarray(np.stack(intr_np_list).astype(np.float32))
        run_vol = _pl._make_volume_batch(
            config, pres[0].image_size, pres[0].kf_scale, True
        )
        fused_handles = run_vol(
            pts_b, valid_b, pmask_b, ext_b, intr_b, sig_b, par_b,
            result.rmse[:n_videos].astype(jnp.float32),
        )
        pass  # fused_handles stays the (V, 6) matrix — ONE fetch buffer
    else:
        fused_handles = [
            _estimate_volume(
                result.points[i, : len(pres[i].points)],
                pres[i].intrinsics,
                ext4_dev[i],
                pres[i].n_kf,
                pres[i].image_size,
                config,
                point_sigma=pres[i].point_sigma,
                point_parallax=pres[i].point_parallax,
                use_plane=not pres[i].markerless,
                kf_scale=pres[i].kf_scale,
            )
            for i in range(n_videos)
        ]
    # Coalesced final fetch: ONE buffer per kind (points as the whole padded
    # (V, P, 3) solve output, extrinsics restacked to a common keyframe pad,
    # the fused volume vectors as one (V, 6) matrix) instead of per-video
    # slices as separate buffers.
    fb_all = max(e.shape[0] for e in ext4_dev)
    ext4_b = jnp.stack(
        [
            jnp.pad(e, ((0, fb_all - e.shape[0]), (0, 0), (0, 0)))
            for e in ext4_dev
        ]
    )
    if not isinstance(fused_handles, (list, tuple)):
        fused_b = fused_handles
    else:
        fused_b = jnp.stack(fused_handles)
    # ONE packed buffer for the whole result set (see _p2_pack_device).
    p_pad = result.points.shape[1]
    packed_tail = jnp.concatenate(
        [
            result.points[:n_videos].astype(jnp.float32).reshape(-1),
            result.rmse[:n_videos].astype(jnp.float32).reshape(-1),
            result.iterations[:n_videos].astype(jnp.float32).reshape(-1),
            ext4_b.astype(jnp.float32).reshape(-1),
            fused_b.astype(jnp.float32).reshape(-1),
        ]
    )
    if _dbg:
        jax.block_until_ready(result.points)
        _mark("solve exec")
        jax.block_until_ready(fused_b)
        _mark("volume exec")
    tail_np = jax.device_get(packed_tail)
    _off = 0

    def _take(n, shape):
        nonlocal _off
        x = tail_np[_off : _off + n].reshape(shape)
        _off += n
        return x

    pts_all = _take(n_videos * p_pad * 3, (n_videos, p_pad, 3))
    rmse_np = _take(n_videos, (n_videos,))
    iters_np = _take(n_videos, (n_videos,))
    ext4_all = _take(n_videos * fb_all * 16, (n_videos, fb_all, 4, 4))
    fused_all = _take(n_videos * 6, (n_videos, 6))
    _mark("final fetch")
    pts_np = [pts_all[i, : len(pres[i].points)] for i in range(n_videos)]
    ext4_np = [ext4_all[i, : pres[i].n_kf] for i in range(n_videos)]
    fused_np = [np.asarray(fused_all[i]) for i in range(n_videos)]

    out: List[ProcessResult] = []
    for i, (pre, metrics, path) in enumerate(zip(pres, metrics_list, paths)):
        pts = np.asarray(pts_np[i])
        rmse = float(rmse_np[i])
        metrics.count("ba_rmse_px", rmse)
        metrics.count("ba_iterations", int(iters_np[i]))
        metrics.count("points", len(pts))

        fused = fused_np[i]
        n_item = int(fused[2])
        if n_item >= 8:
            vol_hull, vol_carve = float(fused[0]), float(fused[1])
        else:
            vol_hull = vol_carve = float("nan")
        metrics.count("item_points", n_item)
        # Same regime check as the single-video path — the sparse-cloud
        # criterion was MEASURED on exactly this shape of input (short batch
        # clips with few-hundred-point clouds), so batch callers must see it.
        volume_confidence = _volume_confidence(
            float(fused[4]), float(fused[5]), n_item, config
        )
        metrics.count("volume_low_confidence", volume_confidence["low_confidence"])

        ply_path = None
        if path is not None:
            ply_path = ply_mod.write_ply(str(path) + "Cloud.ply", pts)

        out.append(
            ProcessResult(
                points=pts,
                extrinsics=np.asarray(ext4_np[i]),
                intrinsics=np.asarray(pre.intrinsics),
                distortion=np.asarray(pre.dist),
                volume=vol_hull,
                volume_carved=vol_carve,
                ply_path=ply_path,
                reprojection_rmse=rmse,
                metrics=metrics.as_dict(),
                volume_confidence=volume_confidence,
            )
        )
    return out
