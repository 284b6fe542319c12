"""Benchmark driver: end-to-end SfM+volume throughput on the headline clip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

Workload (BASELINE.json north star): a 300-frame 1080p synthetic turntable
video -> full pipeline (CLAHE, keyframe scan, ORB, matching, tracks,
calibration, PnP, pose BA, triangulation, Schur BA, volume, PLY). The clip
renders once and caches under .cache/ (gitignored; the v3 tag tracks
the renderer's texture revision — stale clips must not be reused).

``vs_baseline``: ratio of our warm-run fps to the measured OpenCV/SciPy
reference fps on the same clip (BASELINE_MEASURED.json, produced by
``python bench.py --measure-reference``, which also records the reference's
final reprojection RMSE and point count for the parity comparison). The
reference publishes no numbers (BASELINE.md), so the measured baseline is
the parity denominator; until one is recorded, the north-star target
(300 frames / 5 s = 60 fps) is used.

The detail block carries per-stage wall-clock for the cold and warm runs
(cold minus warm ~ compile time per stage), the reference-RMSE parity
ratio, and volume error vs the scene's analytic truth.

``--parity-workload`` additionally times ours at the reference's own
workload knobs (ORB nfeatures=20000 / 8 levels, keyframe threshold 0.1,
exact BGR->LAB CLAHE path — processor.py:308,365,22) so the ratio is
apples-to-apples; the headline stays the tuned config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".cache"
BASELINE_MEASURED = REPO / "BASELINE_MEASURED.json"

N_FRAMES = 300
SIZE = (1920, 1080)


def _host_fingerprint() -> dict:
    """Stable identity of the measuring host + accelerator, so a reader can
    verify the (baseline, ours) pair came from the same machine."""
    import platform

    fp = {"hostname": platform.node(), "machine": platform.machine()}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    fp["cpu"] = line.split(":", 1)[1].strip()
                    break
        fp["nproc"] = len(
            [l for l in open("/proc/cpuinfo") if l.startswith("processor")]
        )
    except OSError:
        pass
    try:
        import jax

        fp["device_kind"] = jax.devices()[0].device_kind
    except Exception:
        pass
    return fp


def _git_sha() -> str:
    try:
        return (
            subprocess.run(
                ["git", "-C", str(REPO), "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip()
            or "unknown"
        )
    except Exception:
        return "unknown"


def get_scene():
    from meatmodeler_tpu.io.synthetic import TurntableScene

    return TurntableScene(image_size=SIZE, focal=1500.0, noise_sigma=1.5)


def load_or_render_clip() -> np.ndarray:
    CACHE.mkdir(exist_ok=True)
    clip_path = CACHE / f"bench_v3_{SIZE[0]}x{SIZE[1]}_{N_FRAMES}.npy"
    if clip_path.exists():
        # Full read (not mmap): the host has RAM for the clip, and lazy page
        # faults otherwise surface as phantom "decimation" time mid-bench.
        return np.load(clip_path)
    from meatmodeler_tpu.io.synthetic import render_sequence

    print(f"rendering {N_FRAMES}-frame {SIZE[0]}x{SIZE[1]} clip (cached after)...", file=sys.stderr)
    frames, _, _ = render_sequence(get_scene(), N_FRAMES, seed=0, backend="jax")
    np.save(clip_path, frames)
    return frames


def bench_config():
    from meatmodeler_tpu.config import (
        DEFAULT_CONFIG,
        KeyframeConfig,
        MatcherConfig,
        OrbConfig,
        TrackConfig,
        VolumeConfig,
    )

    return dataclasses.replace(
        DEFAULT_CONFIG,
        # Denser keyframes than the reference's 0.1 rule: at 1080p the ~27
        # frames between 0.1-threshold keyframes starve ORB matching, and
        # point density drives the volume estimate (the capability the
        # reference never shipped). threshold_abs = 96 is the resolution-
        # invariant form of the old per-resolution rule (0.05 x 1920): one
        # intensity budget, valid at any (resolution, downscale) — the 4K
        # probe below runs the SAME config with no compensation.
        # window=15: the cv2-default 21 at the /6 pass-1 resolution tracks a
        # 6x-larger angular patch than the reference's full-res window.
        # Measured on this clip: win 15 selects the same 20 keyframes within
        # +-3 frames, rmse 0.77 vs 0.75 px, volume_err 0.037 vs 0.038 —
        # and cuts the host scan 1.09 -> 0.79 s (win 11 was rejected:
        # volume_err 0.124).
        # flow_threshold 0.015: the frame-count-invariant displacement
        # trigger. On the 300-frame clip the intensity rule
        # still fires first most intervals (18 -> 21 keyframes, hull err
        # -13.7%); on the 60-frame batch clips (same orbit, 5x the motion
        # per frame) it lifts selection from 5 to 11-12 keyframes and the
        # per-clip volume error from 55-71% to ~15-30% (seed spread).
        keyframe=dataclasses.replace(
            KeyframeConfig(), threshold_abs=96.0, window=15,
            flow_threshold=0.015,
        ),
        orb=OrbConfig(num_features=4096, num_levels=4),
        matcher=MatcherConfig(max_matches=2048),
        # Measured at half-res working resolution (sweep on this clip,
        # checkpointed reconstruction): closing 0.015 of the long side +
        # 0.9 view agreement puts the carve at -6% of analytic truth
        # (defaults: +114%); the hull sits at +2% with max_reproj_px=3.
        # voxel_resolution 64: the per-voxel silhouette lookup (a 33M-
        # element gather at 128^3 x 16 views) was ~90% of the volume
        # program's device time (~0.46 s/video), and the hull/carve errors
        # are IDENTICAL to 3 decimals at 64^3 across every validation
        # capture (the hull is support-body-bound; the carve veto barely
        # bites at voxel granularity).
        volume=dataclasses.replace(
            VolumeConfig(), carve_close_frac=0.015, carve_vote_frac=0.9,
            voxel_resolution=64,
        ),
        # nview: init from ALL observations — tighter cloud, better volume
        # (+7% vs truth against +16% for the endpoints policy), same RMSE.
        tracks=TrackConfig(
            max_tracks=8192,
            max_keyframes=64,
            triangulation="nview",
            # Full-res-equivalent track consistency at half-res keyframes;
            # measured on this clip: hull volume error +57% -> +2%, RMSE
            # 1.05 -> 0.82 (half-res px).
            max_reproj_px=3.0,
        ),
        frame_chunk=32,
        # Every knob below trades bytes moved to the device for image
        # resolution the reconstruction doesn't need.
        # Host-native pass 1: the keyframe scan runs in C++ on the host and
        # NOTHING streams to the device — only selected keyframes upload
        # (the per-frame stream is ~39 MB at /4); measured exact downstream
        # parity with the device scan.
        pass1_backend="host",
        pass1_downscale=6,
        # Keyframes ship as HALF-res grey (one byte per 4 full-res px):
        # CLAHE on BT.601 luma instead of LAB lightness — equivalent on
        # this clip (tinted grey) — and ORB/subpix/calibration run in the
        # half-res pixel units (geometry and volume are resolution-
        # independent; world scale comes from the board side length).
        pass2_downscale=2,
        pass2_enhance="grey",
    )


def parity_config():
    """The reference's own workload knobs (apples-to-apples variant)."""
    from meatmodeler_tpu.config import (
        DEFAULT_CONFIG,
        KeyframeConfig,
        MatcherConfig,
        OrbConfig,
        TrackConfig,
    )

    return dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(KeyframeConfig(), threshold=0.1),
        orb=OrbConfig(num_features=20000, num_levels=8),  # processor.py:308
        matcher=MatcherConfig(max_matches=8192),
        tracks=TrackConfig(max_tracks=32768, max_keyframes=64, triangulation="nview"),
        frame_chunk=32,
        pass2_enhance="bgr_lab",  # the exact processor.py:12-26 path
    )


def run_ours(frames, config, scene, label: str, warm_runs: int = 3) -> dict:
    from meatmodeler_tpu.pipeline import process

    # Force a cached mmap'd clip fully into RAM before any timed run:
    # np.ascontiguousarray returns a np.memmap UNCHANGED (it is already a
    # contiguous ndarray), so pass 1's decimation would otherwise pay disk
    # page faults inside the timed region — measured 0.23 s -> 8.9 s of
    # "decimation" on a cold page cache.
    if isinstance(frames, np.memmap):
        frames = np.array(frames)
    frames = np.ascontiguousarray(frames)

    t0 = time.perf_counter()
    result = process(frames, path=str(CACHE / f"bench_{label}"), config=config)
    cold = time.perf_counter() - t0
    cold_stages = dict(result.metrics["timings"])

    # MEDIAN-of-N warm runs: the median of >= 3 is the typical speed,
    # robust to one stall without cherry-picking the fastest. All samples
    # are recorded, spread included.
    warm_samples = []
    for _ in range(max(1, warm_runs)):
        t0 = time.perf_counter()
        result = process(frames, path=str(CACHE / f"bench_{label}"), config=config)
        warm_samples.append(time.perf_counter() - t0)
    warm = float(np.median(warm_samples))

    counters = result.metrics["counters"]
    vol_truth = float(scene.volume)
    # RMSE is measured in the pass-2 working resolution's pixel units;
    # multiply back to FULL-resolution pixel equivalents for the
    # reference-parity ratio (the reference works at full res).
    p2s = int(counters.get("kf_scale", 1))
    return {
        "rmse_px_fullres_equiv": result.reprojection_rmse * p2s,
        "cold_s": round(cold, 2),
        "warm_s": round(warm, 2),
        "warm_samples_s": [round(t, 2) for t in warm_samples],
        "fps": len(frames) / warm,
        "stage_s": {k: round(v, 3) for k, v in result.metrics["timings"].items()},
        "stage_s_cold": {k: round(v, 3) for k, v in cold_stages.items()},
        "keyframes": int(counters["keyframes"]),
        "points": int(len(result.points)),
        "rmse_px": result.reprojection_rmse,
        "ba_iterations": int(counters.get("ba_iterations", -1)),
        "volume": result.volume,
        "volume_carved": result.volume_carved,
        "volume_truth": vol_truth,
        "volume_err": abs(result.volume - vol_truth) / vol_truth,
        "volume_carved_err": abs(result.volume_carved - vol_truth) / vol_truth,
        "counters": {
            k: v
            for k, v in counters.items()
            if isinstance(v, (int, float, bool)) and not isinstance(v, np.ndarray)
        },
    }


def measure_reference(frames, n_runs: int = 3) -> dict:
    """Median-of-N reference measurement (the parity denominator).

    The reference's FLANN/LSH matcher is randomized (``processor.py:132``):
    single-run RMSE on this clip has been observed anywhere from 40 to
    126 px. N independent runs with the median + spread recorded make the
    denominator reproducible.
    """
    runs = []
    for i in range(n_runs):
        print(f"reference run {i + 1}/{n_runs}...", file=sys.stderr)
        runs.append(_measure_reference_once(frames))

    def med(key):
        vals = [r[key] for r in runs if r.get(key) is not None]
        return float(np.median(vals)) if vals else None

    out = {
        "frames": runs[0]["frames"],
        "seconds": med("seconds"),
        "fps": med("fps"),
        "rmse_px": med("rmse_px"),
        "points": med("points"),
        "ba_residuals": med("ba_residuals"),
        "runs": runs,
        "spread": {
            k: [
                min(r[k] for r in runs if r.get(k) is not None),
                max(r[k] for r in runs if r.get(k) is not None),
            ]
            for k in ("fps", "rmse_px", "points")
            if any(r.get(k) is not None for r in runs)
        },
    }
    return out


def _measure_reference_once(frames) -> dict:
    """Run the OpenCV/SciPy reference pipeline on a prefix of the same clip.

    The reference needs a video file (cv2.VideoCapture) and pyntcloud (not
    installed) — the clip is written to MJPG AVI and pyntcloud is stubbed.
    Per-frame cost is extrapolated from the prefix; the reference's terminal
    global BA grows superlinearly with frames, so this favors the baseline.

    Also records the reference's final-BA reprojection RMSE and point count
    (via a least_squares wrap + the PLY stub): its only accuracy
    instrumentation is the solver's verbose print (bundleAdjuster.py:183),
    which persists nothing.
    """
    import cv2
    import types

    prefix = min(120, len(frames))
    avi = CACHE / "bench_ref.avi"
    writer = cv2.VideoWriter(
        str(avi), cv2.VideoWriter_fourcc(*"MJPG"), 30, SIZE
    )
    if not writer.isOpened():
        raise RuntimeError("cv2.VideoWriter unavailable; cannot measure reference")
    for f in frames[:prefix]:
        writer.write(np.ascontiguousarray(f))
    writer.release()

    captured = {}

    # Stub pyntcloud (unused output stage) before importing the reference.
    # The stub persists in sys.modules across runs, so it must route into
    # the CURRENT run's capture dict — a closure over this run's `captured`
    # would leave later runs' point counts null.
    fake = sys.modules.get("pyntcloud")
    if fake is None or not hasattr(fake, "_bench_capture"):
        fake = types.ModuleType("pyntcloud")
        fake._bench_capture = {}

        class _PC:
            def __init__(self, df):
                fake._bench_capture["points"] = int(len(df))

            def to_file(self, name):
                Path(name).write_text("stub")

        fake.PyntCloud = _PC
        sys.modules["pyntcloud"] = fake
    fake._bench_capture = captured
    sys.path.insert(0, "/root/reference")
    try:
        import bundleAdjuster  # the reference solver module
        import processor  # the reference pipeline

        orig_ls = bundleAdjuster.least_squares

        def wrapped_ls(fun, x0, **kw):
            res = orig_ls(fun, x0, **kw)
            # The LAST call is adjustPoints' global BA (bundleAdjuster.py:180)
            # — its residuals are (proj - obs) pairs, so RMSE in px is the
            # row-norm RMS. Overwritten per call; final value = global BA.
            r = res.fun.reshape(-1, 2)
            captured["rmse_px"] = float(np.sqrt(np.mean(np.sum(r * r, axis=1))))
            captured["ba_residuals"] = int(len(r))
            return res

        bundleAdjuster.least_squares = wrapped_ls

        lk_params = dict(
            winSize=(21, 21),
            maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01),
        )
        feature_params = dict(maxCorners=512, qualityLevel=0.01, minDistance=7, blockSize=7)
        flann_params = dict(
            algorithm=6, table_number=6, key_size=12, multi_probe_level=1
        )
        try:
            t0 = time.perf_counter()
            processor.process(
                str(avi), str(CACHE / "ref"), lk_params, feature_params, flann_params
            )
            elapsed = time.perf_counter() - t0
        finally:
            # Restore: repeat runs must not stack wrappers.
            bundleAdjuster.least_squares = orig_ls
    finally:
        sys.path.remove("/root/reference")

    return {
        "frames": prefix,
        "seconds": elapsed,
        "fps": prefix / elapsed,
        "rmse_px": captured.get("rmse_px"),
        "points": captured.get("points"),
        "ba_residuals": captured.get("ba_residuals"),
    }


# XLA program (module) name -> pipeline stage, for the device-time split.
# Names must follow the pipeline's jit entry points (match_minibatch,
# _adjust_points_jit, hull_and_carved_volume, ...), or their time lands in
# an "other" bucket.
_MODULE_STAGE = (
    ("jit_scan_chunk", "pass1_keyframes"),
    ("jit_init_carry", "pass1_keyframes"),
    ("jit__clahe_grey_batch", "preprocess"),
    ("jit_clahe", "preprocess"),
    ("jit__enhanced_grey_batch", "preprocess"),
    ("jit_board_detect_batch", "board_detect"),
    ("jit_orb_minibatch", "pass2_orb"),
    ("jit_match_minibatch", "pass2_matching"),
    ("jit_match_descriptors", "pass2_matching"),
    ("jit_update_tracks", "pass2_tracks"),
    ("jit_finalize_tracks", "pass2_tracks"),
    ("jit_subpix_minibatch", "subpix"),
    ("jit_calibrate", "calibration"),
    ("jit_pose_stage", "pose_estimation"),
    ("jit__adjust_pose_jit", "pose_estimation"),
    ("jit_chain_step", "pose_chain"),
    ("jit_solve_ba", "bundle_adjustment"),
    ("jit__adjust_points_jit", "bundle_adjustment"),
    ("jit_triangulate_gate", "triangulation"),
    ("jit_triangulate_known", "triangulation"),
    ("jit_split_item_points", "volume"),
    ("jit_hull_and_carved_volume", "volume"),
    ("jit__view_regime", "volume"),
    ("jit_convex_hull_volume", "volume"),
    ("jit_carved_volume", "volume"),
)


def measure_device_time(frames, config, label: str) -> dict:
    """Per-stage DEVICE seconds: re-run the (warm) pipeline under an XProf
    capture and sum the device plane's per-program execution times.

    Wall-clock stage timers cannot split device compute from host
    orchestration and transfer waits; the trace's device timeline can.
    Returns {"device_s": {stage: s}, "modules": {...},
    "total_device_s": s, "wall_s": s, "device_busy_frac": f} or {} when no
    trace/parser is available.
    """
    import shutil

    import jax

    from meatmodeler_tpu.pipeline import process
    from meatmodeler_tpu.utils.xplane import device_time_summary

    trace_dir = CACHE / f"trace_{label}"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    jax.profiler.start_trace(str(trace_dir))
    try:
        process(frames, path=str(CACHE / f"bench_{label}"), config=config)
    finally:
        jax.profiler.stop_trace()
    wall = time.perf_counter() - t0

    summary = device_time_summary(str(trace_dir))
    if not summary:
        return {}
    stages: dict = {}
    for module, secs in summary["modules"].items():
        stage = next((s for m, s in _MODULE_STAGE if module.startswith(m)), "other")
        stages[stage] = round(stages.get(stage, 0.0) + secs, 4)
    return {
        "device_s": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        "modules": summary["modules"],
        "total_device_s": summary["total_device_s"],
        "wall_s": round(wall, 3),
        "device_busy_frac": round(summary["total_device_s"] / max(wall, 1e-9), 4),
        "plane": summary["plane"],
    }


# Published dense bf16 tensor-core peak (FLOP/s) by exact ``device_kind``:
# NVIDIA H100 SXM data sheet, at the card's full 700 W power limit. A
# device not in the table has no peak (None), never an assumed one.
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_kind: str):
    """Published bf16 peak for ``device_kind``, or None if it is unknown."""
    return _PEAK_FLOPS.get(device_kind)


def mxu_utilization_proxy(detail: dict, modules: dict, config) -> dict:
    """Analytic-FLOPs / device-time utilization estimate for the two
    matmul-dominated stages.

    Matching: the Hamming dot_general is (Q, 256) x (256, T) bf16 per
    keyframe pair (ops/matching.py::hamming_matrix). BA: per LM iteration,
    two attempted steps each assemble the Schur cross term (216*P*F^2 flops),
    the strip product (108*P*F) and the (6F)^3/3 reduced solve
    (solvers/bundle_adjust.py::_solve_normal_equations). A PROXY: it counts
    only the dominant matmuls (real utilization is higher) against the
    card's bf16 peak (the BA runs f32, whose peak is lower) — good for
    order-of-magnitude and trend, not absolutes.
    """
    import jax

    kind = jax.devices()[0].device_kind
    peak = peak_flops(kind)
    out = {"device_kind": kind, "peak_bf16_flops": peak}

    def mod_time(*prefixes):
        # Sum across program-name prefixes: the pipeline's matching/BA run
        # under wrapper programs (match_minibatch, _adjust_points_jit), and
        # XLA may uniquify names.
        t = sum(s for name, s in modules.items() if name.startswith(prefixes))
        return t or None

    kf = int(detail.get("keyframes", 0))
    q = config.orb.num_features
    t_match = mod_time("jit_match_minibatch", "jit_match_descriptors")
    if kf >= 2 and t_match:
        flops = (kf - 1) * 2.0 * q * q * 256
        rate = flops / t_match
        out["matching"] = {
            "analytic_tflops": round(flops / 1e12, 4),
            "device_s": t_match,
            "tflops_per_s": round(rate / 1e12, 3),
            "mxu_util_proxy": round(rate / peak, 4) if peak else None,
        }

    pts = int(detail.get("points", 0))
    iters = int(detail.get("ba_iterations", 0))
    t_ba = mod_time("jit_solve_ba", "jit__adjust_points_jit")
    if pts and iters > 0 and t_ba:
        pb = -(-pts // 256) * 256  # solver bucket padding (SolverConfig.bucket)
        fb = -(-kf // 4) * 4
        per_iter = 2 * (216.0 * pb * fb * fb + 108.0 * pb * fb + (6 * fb) ** 3 / 3)
        flops = iters * per_iter
        rate = flops / t_ba
        out["bundle_adjustment"] = {
            "analytic_tflops": round(flops / 1e12, 4),
            "device_s": t_ba,
            "tflops_per_s": round(rate / 1e12, 3),
            "mxu_util_proxy": round(rate / peak, 4) if peak else None,
        }
    return out


# ---------------------------------------------------------------------------
# Marker-free bench variant: a board-free 720p clip
# reconstructed up-to-scale; accuracy quantified by Umeyama-aligning the
# keyframe POSES (centers + forward/down axis anchors — centers alone lie on
# a near-1D arc and leave the rotation about its chord unconstrained) to the
# renderer's exact ground truth, plus the item points' implicit-surface
# residual against the true ellipsoid.
# ---------------------------------------------------------------------------

MF_FRAMES = 120
MF_SIZE = (1280, 720)


def markerless_scene():
    from meatmodeler_tpu.io.synthetic import TurntableScene

    # ground_texture: a compact textured object over a FEATURELESS sheet is
    # gauge-ambiguous for monocular SfM (bas-relief family — measured: a
    # 27-deg-off pose ties the truth at 0.58 px reprojection). Real tabletop
    # sheets have grain; a few grey levels of it puts background parallax in
    # view and makes the accuracy gates meaningful (io/synthetic.py).
    return TurntableScene(
        image_size=MF_SIZE, focal=1000.0, noise_sigma=1.0, show_board=False,
        ground_texture=12.0,
    )


def load_or_render_markerless_clip():
    CACHE.mkdir(exist_ok=True)
    clip = CACHE / f"bench_mf_v3_{MF_SIZE[0]}x{MF_SIZE[1]}_{MF_FRAMES}.npy"
    poses_p = CACHE / f"bench_mf_v3_{MF_SIZE[0]}x{MF_SIZE[1]}_{MF_FRAMES}_poses.npy"
    if clip.exists() and poses_p.exists():
        return np.load(clip), np.load(poses_p)
    from meatmodeler_tpu.io.synthetic import render_sequence

    print("rendering marker-free clip (cached after)...", file=sys.stderr)
    # Grey render (color=False): the markerless pipeline takes (T, H, W)
    # directly and the one-time device->host readback is 3x smaller.
    frames, poses, _ = render_sequence(
        markerless_scene(), MF_FRAMES, seed=1, color=False, backend="jax"
    )
    np.save(clip, frames)
    np.save(poses_p, poses)
    return frames, poses


def _pose_anchors(rot: np.ndarray, tvec: np.ndarray, d: float) -> np.ndarray:
    """Three alignment anchors per camera: center, +forward*d, +down*d."""
    c = -rot.T @ tvec
    return np.stack(
        [c, c + rot.T @ np.array([0.0, 0.0, 1.0]) * d, c + rot.T @ np.array([0.0, 1.0, 0.0]) * d]
    )


def markerless_config(focal: float = 0.0, base=None):
    """The marker-free variant of ``base`` (default: the bench config):
    ``focal=0`` assumes the pipeline's 1.2*max(W,H) prior, ``focal>0`` is
    EXIF-style known intrinsics."""
    base = base if base is not None else bench_config()
    return dataclasses.replace(
        base,
        pass1_downscale=4,  # 720p: /4 host scan still selects densely enough
        # No displacement trigger here: the marker-free chain needs PER-PAIR
        # baseline (each step is an essential-matrix/PnP problem), and the
        # denser keyframes the trigger selects SHRINK per-pair parallax —
        # measured: 8 -> 14 keyframes collapsed the chain's cloud 1977 ->
        # 734 points and doubled aligned pose error. The trigger exists for
        # short BOARD clips, whose pose comes per-frame from the board.
        keyframe=dataclasses.replace(base.keyframe, flow_threshold=0.0),
        markerless_focal=focal,
        # The deployment pose this variant models: the caller knows the
        # footage has no board (and supplies EXIF focal when available), so
        # pass 1 skips the board hunt + the board-gated scan that the
        # auto-fallback path (exercised by the board-free e2e test) pays.
        assume_markerless=True,
    )


def run_markerless(frames, gt_poses, scene, focal: float = 0.0) -> dict:
    """Marker-free accuracy variant. ``focal=0``: the pipeline's assumed
    1.2*max(W,H) prior. ``focal>0``: EXIF-style KNOWN intrinsics — the
    deployment-realistic mode, and the only well-posed one on this clip:
    a turntable orbit is a critical motion sequence for monocular
    self-calibration (Sturm 1997), so no estimator can recover focal from
    the footage and the assumed-focal reconstruction carries an
    irreducible projective distortion that the similarity alignment
    (correctly) reports as pose/surface error."""
    from meatmodeler_tpu import pipeline
    from meatmodeler_tpu.geometry import so3
    from meatmodeler_tpu.pipeline import process
    from meatmodeler_tpu.utils.alignment import umeyama

    config = markerless_config(focal)
    process(frames, path=str(CACHE / "bench_mf"), config=config)  # compile

    # Capture the final BA's observation set: gt_config_rmse_px below scores
    # the GROUND-TRUTH poses on the same observations — when it is >= the
    # solution's RMSE, the remaining aligned-pose error is the scene's
    # information limit (an arc-curvature near-ambiguity family), not an
    # estimator deficiency.
    captured = {}
    orig_solve = pipeline._solve_and_finish

    def hook(pre, cfg, path, metrics, ckpt):
        captured["pre"] = pre
        return orig_solve(pre, cfg, path, metrics, ckpt)

    pipeline._solve_and_finish = hook
    try:
        # Median-of-3 warm runs (same policy as the headline).
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            result = process(frames, path=str(CACHE / "bench_mf"), config=config)
            samples.append(time.perf_counter() - t0)
        elapsed = float(np.median(samples))
    finally:
        pipeline._solve_and_finish = orig_solve
    counters = result.metrics["counters"]
    assert counters.get("markerless") is True, "markerless path did not engage"

    kf_idx = counters["keyframe_indices"]
    ext = result.extrinsics
    d = scene.ring_radius / 3.0
    src = np.concatenate(
        [_pose_anchors(ext[i, :3, :3], ext[i, :3, 3], d) for i in range(len(ext))]
    )
    import jax.numpy as jnp

    dst = np.concatenate(
        [
            _pose_anchors(np.asarray(so3.exp(jnp.asarray(p[:3]))), p[3:], d)
            for p in np.asarray(gt_poses)[kf_idx]
        ]
    )
    tf = umeyama(src, dst)
    res = tf.apply(src) - dst
    pose_rmse = float(np.sqrt((res * res).sum(axis=1).mean()))

    pts = tf.apply(result.points)
    c = np.array(scene.ellipsoid_center)
    ax = np.array(scene.ellipsoid_axes)
    # Distance to the nearest TRUE surface: the scene has two — the item
    # ellipsoid and the textured ground sheet (y = 0 plane) — and both
    # legitimately contribute tracked points. Both terms are normalized by
    # the ellipsoid axes so "0.05" reads as 5% of the item's size.
    ell_res = np.abs(np.linalg.norm((pts - c) / ax, axis=1) - 1.0)
    plane_res = np.abs(pts[:, 1]) / float(np.mean(ax))
    implicit = np.minimum(ell_res, plane_res)

    gt_rmse = float("nan")
    pre = captured.get("pre")
    if pre is not None:
        from meatmodeler_tpu.geometry import projection, triangulation
        import jax.numpy as jnp

        gt6 = np.asarray(gt_poses)[kf_idx].astype(np.float32)
        ext_gt = projection.extrinsics_from_params(jnp.asarray(gt6))
        k = jnp.asarray(pre.intrinsics, jnp.float32)
        fidx = np.asarray(pre.fidx)
        pidx = np.asarray(pre.pidx)
        n_pts = pre.points.shape[0]
        coords = np.zeros((n_pts, len(gt6), 2), np.float32)
        om = np.zeros((n_pts, len(gt6)), bool)
        coords[pidx, fidx] = np.asarray(pre.obs)
        om[pidx, fidx] = True
        projm = projection.projection_from_extrinsic(k, ext_gt)
        pts_gt = triangulation.triangulate_nview(
            projm, jnp.asarray(coords), jnp.asarray(om)
        )
        ph = jnp.concatenate([pts_gt, jnp.ones((n_pts, 1))], 1)
        uvw = jnp.einsum(
            "oij,oj->oi", projm[jnp.asarray(fidx)], ph[jnp.asarray(pidx)]
        )
        res_gt = np.asarray(uvw[:, :2] / uvw[:, 2:3] - np.asarray(pre.obs))
        ok = om.sum(1)[pidx] >= 2
        gt_rmse = float(np.sqrt((res_gt[ok] ** 2).sum(1).mean()))

    return {
        "frames": len(frames),
        "seconds": round(elapsed, 2),
        "warm_samples_s": [round(t, 2) for t in samples],
        "fps": round(len(frames) / elapsed, 2),
        "keyframes": int(counters["keyframes"]),
        "points": int(len(result.points)),
        "rmse_px": result.reprojection_rmse,
        "gauge_scale": round(tf.scale, 4),
        # Umeyama-aligned pose-anchor RMSE, absolute and relative to the
        # camera-ring radius (the scene's natural scale).
        "aligned_pose_rmse": round(pose_rmse, 4),
        "aligned_pose_rmse_vs_ring": round(pose_rmse / scene.ring_radius, 4),
        # Median |distance-to-ellipsoid| of the aligned item points, in
        # units of the ellipsoid's (normalized) semi-axes.
        "point_surface_residual_median": round(float(np.median(implicit)), 4),
        "point_surface_residual_p90": round(float(np.percentile(implicit, 90)), 4),
        # Reprojection RMSE of the GROUND-TRUTH poses (points re-triangulated
        # from them) on the SAME observations: >= rmse_px means the solution
        # fits the image evidence at least as well as truth — the aligned
        # pose error above is then the scene's information limit.
        "gt_config_rmse_px": round(gt_rmse, 4),
        # Warm per-stage wall seconds — what the marker-free fps is made of
        # (the chain stages `pose_chain`/`pose_ba` replace board detection).
        "stage_s": {k: round(v, 3) for k, v in result.metrics["timings"].items()},
    }


# ---------------------------------------------------------------------------
# Batch (BASELINE config "16 concurrent videos") evidence: N short 1080p
# clips through process_batch on one card — per-video + aggregate fps and
# the device-memory peak, plus the 4K-shape check below.
# ---------------------------------------------------------------------------

BATCH_VIDEOS = 8
BATCH_FRAMES = 60


def load_or_render_batch_clips(n=BATCH_VIDEOS):
    from meatmodeler_tpu.io.synthetic import render_sequence

    CACHE.mkdir(exist_ok=True)
    clips = []
    for i in range(n):
        p = CACHE / f"bench_batch_v1_{SIZE[0]}x{SIZE[1]}_{BATCH_FRAMES}_s{i}.npy"
        if not p.exists():
            print(f"rendering batch clip {i + 1}/{n} (cached after)...", file=sys.stderr)
            frames, _, _ = render_sequence(
                get_scene(), BATCH_FRAMES, seed=100 + i, backend="jax"
            )
            np.save(p, frames)
        clips.append(np.ascontiguousarray(np.load(p)))
    return clips


def _hbm_peak_bytes() -> int | None:
    """PROCESS-LIFETIME peak HBM (when the backend reports memory_stats).

    There is no per-section reset API, so a section's number is
    max(everything run so far in this process) — an upper bound on the
    section's own peak, and the batch/4K numbers are not independent of the
    earlier headline runs. Read it as "the whole bench fits in this much
    HBM", not as a per-section footprint."""
    import jax

    try:
        stats = jax.devices()[0].memory_stats() or {}
        return int(stats.get("peak_bytes_in_use", 0)) or None
    except Exception:
        return None


def _hbm_evidence() -> dict:
    """Device-memory usage: ``memory_stats`` byte counters, and
    ``live_bytes``, the sum over ``jax.live_arrays()`` of committed device
    buffers right now (a lower bound on resident memory)."""
    import jax

    out: dict = {}
    try:
        stats = jax.devices()[0].memory_stats() or {}
        if stats:
            out["memory_stats"] = {
                k: int(v)
                for k, v in stats.items()
                if isinstance(v, (int, float)) and "bytes" in k
            }
    except Exception:
        pass
    try:
        out["live_bytes"] = int(sum(a.nbytes for a in jax.live_arrays()))
    except Exception:
        pass
    return out


def _compiled_memory_probe(fn, *args) -> dict | None:
    """XLA's own peak-memory analysis for one jitted call at real shapes."""
    try:
        import jax

        an = jax.jit(fn).lower(*args).compile().memory_analysis()
        if an is None:
            return None
        return {
            "argument_bytes": int(getattr(an, "argument_size_in_bytes", 0)),
            "output_bytes": int(getattr(an, "output_size_in_bytes", 0)),
            "temp_bytes": int(getattr(an, "temp_size_in_bytes", 0)),
            "peak_bytes": int(
                getattr(an, "argument_size_in_bytes", 0)
                + getattr(an, "output_size_in_bytes", 0)
                + getattr(an, "temp_size_in_bytes", 0)
            ),
        }
    except Exception:
        return None


def run_batch_bench(config, scene) -> dict:
    """N-video process_batch on the single chip: cold + warm wall, per-video
    accuracy spread, HBM peak."""
    from meatmodeler_tpu.parallel.batch import process_batch

    clips = load_or_render_batch_clips()
    n = len(clips)
    total_frames = sum(len(c) for c in clips)

    t0 = time.perf_counter()
    process_batch(clips, config=config)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = process_batch(clips, config=config)
    warm = time.perf_counter() - t0

    vol_truth = float(scene.volume)
    rmses = [round(r.reprojection_rmse, 3) for r in results]
    vols = [round(abs(r.volume - vol_truth) / vol_truth, 3) for r in results]
    return {
        "videos": n,
        "frames_per_video": BATCH_FRAMES,
        "resolution": f"{SIZE[0]}x{SIZE[1]}",
        "cold_s": round(cold, 2),
        "warm_s": round(warm, 2),
        "aggregate_fps": round(total_frames / warm, 2),
        "per_video_fps": round(total_frames / warm / n, 2),
        "rmse_px": rmses,
        "volume_err": vols,
        "low_confidence": [bool(r.volume_confidence["low_confidence"]) for r in results],
        "points": [len(r.points) for r in results],
        "hbm_peak_bytes": _hbm_peak_bytes(),
        "hbm": _hbm_evidence(),
    }


def run_4k_shape_check(config) -> dict:
    """Compile/memory probe at the 4K frame shape (BASELINE config 4's unit):
    a short 3840x2160 clip (1080p bench frames pixel-doubled — identical
    content statistics, zero extra render cost) through the full pipeline."""
    from meatmodeler_tpu.pipeline import process

    # 60 frames ~ 4 keyframe intervals at the bench selection density — a
    # 24-frame probe only ever selected 1-2 keyframes and failed the >= 3
    # floor regardless of resolution handling.
    frames = load_or_render_clip()[:60]
    f4k = np.repeat(np.repeat(frames, 2, axis=1), 2, axis=2)
    # Doubled downscales: a WORK choice, not a threshold compensation — the
    # pixel-doubled frames carry the same content, so doubling the divisors
    # keeps the working resolutions (and the scan/ORB cost) identical to the
    # 1080p run while still exercising the 4K ingest/decimation/memory path.
    # The keyframe rule itself needs NO adjustment anymore: threshold_abs is
    # a constant intensity budget, invariant to resolution and downscale
    # (tests/test_pipeline.py pins selection density across downscales).
    cfg4k = dataclasses.replace(
        config,
        pass1_downscale=config.pass1_downscale * 2,
        pass2_downscale=config.pass2_downscale * 2,
    )
    t0 = time.perf_counter()
    result = process(f4k, path=str(CACHE / "bench_4k"), config=cfg4k)
    elapsed = time.perf_counter() - t0
    out = {
        "frames": len(f4k),
        "resolution": "3840x2160",
        "seconds": round(elapsed, 2),
        "keyframes": int(result.metrics["counters"]["keyframes"]),
        "rmse_px": round(result.reprojection_rmse, 3),
        "points": len(result.points),
        "hbm_peak_bytes": _hbm_peak_bytes(),
        "hbm": _hbm_evidence(),
    }
    # 2x4K batch probe: the BASELINE config-5 shape scaled to one card —
    # two concurrent 4K videos through
    # process_batch, with the same HBM sources recorded after.
    try:
        from meatmodeler_tpu.parallel.batch import process_batch

        t0 = time.perf_counter()
        rs = process_batch([f4k, f4k[: len(f4k)]], config=cfg4k)
        out["batch_2x4k"] = {
            "seconds": round(time.perf_counter() - t0, 2),
            "rmse_px": [round(r.reprojection_rmse, 3) for r in rs],
            "hbm": _hbm_evidence(),
        }
    except Exception as e:  # pragma: no cover — diagnostic, not headline
        out["batch_2x4k"] = {"error": repr(e)}
    return out


def run_pp_bench(config) -> dict:
    """Pipeline-parallel schedule at bench scale.

    Two 300-frame 1080p clips (the bench clip + a second-seed render)
    through ``parallel.pipelined.process_batch_pipelined`` vs the same two
    sequentially. On one card both PP stages' device programs share it, so the win is bounded by how much of stage 2
    (global BA + volume + PLY) overlaps stage 1's host-bound phases
    (decode + C++ scan + board resolution) — the honest question this row
    answers is whether the 1F1B handoff beats plain sequential at all here.
    """
    from meatmodeler_tpu.parallel.pipelined import process_batch_pipelined
    from meatmodeler_tpu.pipeline import process

    clips = [load_or_render_clip()]
    p2 = CACHE / f"bench_pp_{SIZE[0]}x{SIZE[1]}_{N_FRAMES}.npy"
    if not p2.exists():
        from meatmodeler_tpu.io.synthetic import render_sequence

        print("rendering PP second clip (cached after)...", file=sys.stderr)
        frames, _, _ = render_sequence(get_scene(), N_FRAMES, seed=7, backend="jax")
        np.save(p2, frames)
    clips.append(np.ascontiguousarray(np.load(p2)))
    clips[0] = np.ascontiguousarray(clips[0])
    total = sum(len(c) for c in clips)

    # Warm both paths once (shared programs), then INTERLEAVE the timed
    # samples (S, P, S, P) and take medians, so that a slow spell of the
    # machine cannot land entirely on one schedule.
    process_batch_pipelined(clips, config=config)
    seq_samples, pp_samples = [], []
    rs_pp = rs_seq = None
    for _ in range(2):
        t0 = time.perf_counter()
        rs_seq = [process(c, config=config) for c in clips]
        seq_samples.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rs_pp = process_batch_pipelined(clips, config=config)
        pp_samples.append(time.perf_counter() - t0)
    pp_s = float(np.median(pp_samples))
    seq_s = float(np.median(seq_samples))
    return {
        "videos": len(clips),
        "frames_total": total,
        "pipelined_s": round(pp_s, 2),
        "sequential_s": round(seq_s, 2),
        "pipelined_samples_s": [round(t, 2) for t in pp_samples],
        "sequential_samples_s": [round(t, 2) for t in seq_samples],
        "pipelined_fps": round(total / pp_s, 2),
        "sequential_fps": round(total / seq_s, 2),
        "speedup": round(seq_s / pp_s, 3),
        "rmse_px": [round(r.reprojection_rmse, 3) for r in rs_pp],
        "rmse_px_sequential": [round(r.reprojection_rmse, 3) for r in rs_seq],
    }


ROBUSTNESS_KINDS = ("noise", "blur", "flicker", "jpeg", "occlusion")


def run_robustness_bench(config, scene) -> dict:
    """Degraded-capture families through the FULL pipeline.

    Every earlier bench number came from clean synthetic renders; the
    reference's operating domain is hand-held real video
    (``processor.py:294-319``) with sensor noise, motion blur, exposure
    hunting, codec artifacts, and occlusions. Each family from
    ``io.synthetic.degrade_sequence`` is applied post-render (ground truth
    unchanged) to an every-2nd-frame subsample of the bench clip (full
    orbit, half the frames), alongside a CLEAN control row of the same
    geometry — degradation effects read against the control, not against
    the 300-frame headline.

    Per row: keyframes / points / rmse / volume error / confidence flag,
    plus ``within_bounds`` — rmse <= max(2x clean, 1 px working) AND
    (volume_err <= 0.35 OR the result is honestly low-confidence-flagged).
    """
    from meatmodeler_tpu.io.synthetic import degrade_sequence
    from meatmodeler_tpu.pipeline import process

    frames = load_or_render_clip()[::2]
    frames = np.ascontiguousarray(frames)
    vol_truth = float(scene.volume)

    def row(clip, label):
        t0 = time.perf_counter()
        r = process(clip, config=config)
        dt = time.perf_counter() - t0
        c = r.metrics["counters"]
        vol_err = abs(r.volume - vol_truth) / vol_truth
        return {
            "keyframes": int(c["keyframes"]),
            "points": int(len(r.points)),
            "rmse_px": round(r.reprojection_rmse, 3),
            "volume_err": round(vol_err, 3) if math.isfinite(vol_err) else None,
            "low_confidence": bool(r.volume_confidence["low_confidence"]),
            "confidence_reason": r.volume_confidence["reason"][:120],
            "seconds": round(dt, 2),
        }

    out = {"frames": len(frames), "clean": row(frames, "clean")}
    clean = out["clean"]
    rmse_bound = max(2.0 * clean["rmse_px"], 1.0)
    for kind in ROBUSTNESS_KINDS:
        try:
            r = row(degrade_sequence(frames, kind, seed=5), kind)
            ve = r["volume_err"]
            r["within_bounds"] = bool(
                r["rmse_px"] <= rmse_bound
                and (
                    (ve is not None and ve <= 0.35) or r["low_confidence"]
                )
            )
            out[kind] = r
        except Exception as e:
            # A family that breaks reconstruction outright is itself a
            # finding — record it honestly instead of dying.
            out[kind] = {"error": repr(e), "within_bounds": False}
    out["bounds"] = {
        "rmse_px_max": round(rmse_bound, 3),
        "volume_err_max_unless_flagged": 0.35,
    }
    return out


def _json_sanitize(x):
    """NaN/inf -> null: ``json.dumps`` would otherwise print bare ``NaN``,
    which is invalid strict JSON (a sub-8-point batch clip's volume_err is
    NaN by design)."""
    if isinstance(x, dict):
        return {k: _json_sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_sanitize(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _emit(out: dict) -> None:
    print(json.dumps(_json_sanitize(out)), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--measure-reference", action="store_true")
    parser.add_argument(
        "--reference-runs", type=int, default=3,
        help="runs to median over for --measure-reference",
    )
    parser.add_argument(
        "--parity-workload",
        action="store_true",
        help="also time ours at the reference's workload knobs (20000 ORB "
        "features / 8 levels / 0.1 keyframe threshold)",
    )
    parser.add_argument(
        "--skip-markerless", action="store_true",
        help="skip the marker-free accuracy variant",
    )
    parser.add_argument(
        "--skip-device-accounting", action="store_true",
        help="skip the profiled run + per-stage device-time summary",
    )
    parser.add_argument(
        "--skip-device-pass1", action="store_true",
        help="skip the pass1_backend=device config row",
    )
    parser.add_argument(
        "--skip-batch", action="store_true",
        help="skip the multi-video batch + 4K-shape sections",
    )
    parser.add_argument(
        "--skip-robustness", action="store_true",
        help="skip the degraded-capture robustness section",
    )
    args = parser.parse_args(argv)

    frames = load_or_render_clip()

    if args.measure_reference:
        ref = measure_reference(frames, n_runs=args.reference_runs)
        ref["host"] = _host_fingerprint()
        ref["recorded_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        ref["git_sha"] = _git_sha()
        BASELINE_MEASURED.write_text(json.dumps(ref, indent=2))
        print(json.dumps({k: v for k, v in ref.items() if k != "runs"}), file=sys.stderr)
        return 0

    scene = get_scene()
    config = bench_config()
    ours = run_ours(frames, config, scene, "tuned")
    # Device memory right after the headline run, before later sections
    # raise the process-lifetime peak.
    ours["hbm"] = _hbm_evidence()

    ref = json.loads(BASELINE_MEASURED.read_text()) if BASELINE_MEASURED.exists() else {}
    ref_fps = ref.get("fps", 60.0)  # fallback: north-star proxy (300 f / 5 s)
    if ref.get("rmse_px"):
        ours["rmse_ref_px"] = ref["rmse_px"]
        ours["rmse_vs_ref"] = ours["rmse_px_fullres_equiv"] / ref["rmse_px"]
        ours["points_ref"] = ref.get("points")
        if "spread" in ref:
            ours["ref_spread"] = ref["spread"]
    # The baseline denominator is only meaningful when it was measured on
    # THIS host — record both fingerprints so a reader can check they match.
    ours["host"] = _host_fingerprint()
    ours["baseline_host"] = ref.get("host")

    if not args.skip_device_accounting:
        # Third (warm) run under an XProf capture: per-stage device seconds
        # + the utilization proxy for matching and BA.
        try:
            acct = measure_device_time(frames, config, "tuned")
            if acct:
                ours["device_s"] = acct["device_s"]
                ours["device_total_s"] = acct["total_device_s"]
                ours["device_busy_frac"] = acct["device_busy_frac"]
                ours["device_profiled_wall_s"] = acct["wall_s"]
                ours["mxu"] = mxu_utilization_proxy(ours, acct["modules"], config)
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["device_s_error"] = repr(e)

    if not args.skip_device_pass1:
        # The DEVICE-native pass 1 (the library default): the lax.scan
        # keyframe program with every downscaled frame streamed to the
        # card. Recorded EVERY run alongside the host-scan headline so both
        # configurations carry numbers.
        try:
            cfg_dev = dataclasses.replace(config, pass1_backend="device")
            dev = run_ours(frames, cfg_dev, scene, "tuned_dev")
            row = {
                k: dev[k]
                for k in (
                    "fps", "warm_s", "warm_samples_s", "cold_s", "keyframes",
                    "points", "rmse_px", "stage_s",
                )
            }
            row["vs_baseline"] = round(dev["fps"] / ref_fps, 3)
            row["vs_host_pass1"] = round(dev["fps"] / ours["fps"], 3)
            if not args.skip_device_accounting:
                acct = measure_device_time(frames, cfg_dev, "tuned_dev")
                if acct:
                    row["device_s"] = acct["device_s"]
                    row["device_busy_frac"] = acct["device_busy_frac"]
                    row["device_total_s"] = acct["total_device_s"]
            ours["device_pass1"] = row
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["device_pass1"] = {"error": repr(e)}

    if not args.skip_markerless and os.environ.get(
        "MEATMODELER_BENCH_MARKERLESS", "1"
    ) not in ("0", ""):
        try:
            mf_frames, mf_poses = load_or_render_markerless_clip()
            mf = np.ascontiguousarray(mf_frames)
            scene_mf = markerless_scene()
            ours["markerless"] = run_markerless(mf, mf_poses, scene_mf)
            # EXIF-style known intrinsics: the chain's accuracy without the
            # irreducible assumed-focal distortion (see run_markerless).
            ours["markerless_known_focal"] = run_markerless(
                mf, mf_poses, scene_mf, focal=scene_mf.focal
            )
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["markerless"] = {"error": repr(e)}

    if not args.skip_batch:
        try:
            ours["batch"] = run_batch_bench(config, scene)
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["batch"] = {"error": repr(e)}
        try:
            ours["shape_4k"] = run_4k_shape_check(config)
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["shape_4k"] = {"error": repr(e)}

    if not args.skip_robustness:
        try:
            ours["robustness"] = run_robustness_bench(config, scene)
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["robustness"] = {"error": repr(e)}

    if not args.skip_batch:
        try:
            ours["pipelined"] = run_pp_bench(config)
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["pipelined"] = {"error": repr(e)}

    if args.parity_workload:
        try:
            par = run_ours(frames, parity_config(), scene, "parity")
            rec = {
                k: par[k]
                for k in ("fps", "warm_s", "cold_s", "keyframes", "points", "rmse_px")
            }
            rec["vs_baseline"] = round(par["fps"] / ref_fps, 3)
            ours["parity_workload"] = rec
        except Exception as e:  # pragma: no cover — diagnostic, not headline
            ours["parity_workload"] = {"error": repr(e)}

    out = {
        "metric": "e2e_sfm_volume_fps_1080p",
        "value": round(ours["fps"], 3),
        "unit": "frames/sec",
        "vs_baseline": round(ours["fps"] / ref_fps, 3),
        "detail": ours,
    }
    _emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
