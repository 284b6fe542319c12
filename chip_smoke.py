#!/usr/bin/env python3
"""Smoke run of the video-to-volume pipeline on an NVIDIA GPU.

    python chip_smoke.py             # one card
    python chip_smoke.py --four-gpu  # the multi-device paths, four cards

One card runs four phases, each printing one JSON line:

  device          the card, its power limit, its memory limit and the
                  compile-cache directory in use;
  parity          the code the card runs against the same functions on the
                  CPU backend (or ground truth) at the pipeline's real
                  widths, each with its tolerance and the reason for it;
  ondevice_tests  the ``gpu``-marked pytest subset, in this process;
  e2e             ``process`` on the 300-frame 1080p board clip with the
                  host and the device pass 1, the 720p marker-free clip,
                  and ``process_batch`` over 8 x 60-frame 1080p clips, each
                  held to the benchmark's quality gates.

``--four-gpu`` runs only the paths that span cards and what each is
compared with: ``process_batch`` over a ``data=4`` mesh against one card,
``process_batch_pipelined`` on cards 0 and 1 against sequential
``process``, and a point-sharded ``adjust_points`` against the one-card
solve.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero without that line; it also refuses to run when
JAX finds no GPU. Clips are rendered in memory from fixed seeds; one JAX
process holds the cards, and only ``nvidia-smi`` runs beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The headline deployment (bench.py): a turntable capture at 1080p with the
# calibration board, 300 frames; 8 x 60-frame clips for the batch.
HEADLINE_FRAMES = 300
BATCH_VIDEOS = 8
BATCH_FRAMES = 60
# Quality gates of the benchmark's robustness section (bench.py).
RMSE_MAX_PX = 1.0
VOLUME_ERR_MAX = 0.35
# tests/test_native_pass1.py holds the device scan's full-pipeline keyframe
# count to within 2 of the host scan's.
KEYFRAME_DENSITY_TOL = 2


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj, default=_jsonable), flush=True)


def _jsonable(x):
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peak_bytes(device) -> int | None:
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def phase_device(jax, n_devices: int) -> dict:
    from meatmodeler_tpu.io.native_pass1 import host_pass1_available
    from meatmodeler_tpu.ops.chessboard import host_detector_available

    devices = jax.devices()
    check(
        len(devices) >= n_devices,
        f"needs {n_devices} GPUs, JAX sees {len(devices)}",
    )
    d = devices[0]
    info = {
        "phase": "device",
        "devices": [str(x) for x in devices],
        "device_kind": d.device_kind,
        "nvidia_smi": nvidia_smi(),
        "bytes_limit": (d.memory_stats() or {}).get("bytes_limit"),
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
        "jax": jax.__version__,
        "opencv_importable": host_detector_available(),
        "native_pass1_built": host_pass1_available(),
    }
    emit(info)
    return info


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def ring_problem(n_f: int, n_p: int, noise_px: float, seed: int):
    """Ring of cameras around a point cloud, every point seen by every
    camera: the adjust_points problem with ground truth (numpy)."""
    from meatmodeler_tpu.geometry import so3

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_p, 3)).astype(np.float32)
    k = np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1]], np.float32)
    ext = []
    for i in range(n_f):
        ang = 1.2 * i / n_f - 0.6
        r = np.asarray(so3.exp(np.array([0.0, ang, 0.0], np.float32)), np.float64)
        c = np.array([10.0 * np.sin(ang), 0.5, -10.0 * np.cos(ang)])
        ext.append(np.concatenate([r, (-r @ c)[:, None]], axis=1))
    ext = np.stack(ext).astype(np.float32)  # (F, 3, 4)
    cam = np.einsum("fij,pj->fpi", ext[:, :, :3].astype(np.float64), pts) + ext[:, None, :, 3]
    uvw = cam @ k.T.astype(np.float64)
    uv = uvw[..., :2] / uvw[..., 2:3]
    obs = (uv.reshape(-1, 2) + rng.normal(0, noise_px, (n_f * n_p, 2))).astype(np.float32)
    fidx = np.repeat(np.arange(n_f, dtype=np.int32), n_p)
    pidx = np.tile(np.arange(n_p, dtype=np.int32), n_f)
    pts0 = (pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
    ext4 = np.concatenate(
        [ext, np.broadcast_to(np.array([[[0, 0, 0, 1]]], np.float32), (n_f, 1, 4))], axis=1
    )
    return dict(ext=ext4, k=k, pts0=pts0, obs=obs, fidx=fidx, pidx=pidx, pts=pts)


def board_views(n_views: int, seed: int):
    """A 9x6 board in ``n_views`` tilted views, exact projections."""
    from meatmodeler_tpu.geometry import so3

    rng = np.random.default_rng(seed)
    k_true = np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1]])
    obj = np.zeros((54, 3))
    obj[:, 0] = np.tile(np.arange(9), 6)
    obj[:, 1] = np.repeat(np.arange(6), 9)
    views = []
    for _ in range(n_views):
        rvec = np.deg2rad(rng.uniform(-30, 30, 3) * [1, 1, 0.4]).astype(np.float32)
        tvec = np.array([rng.uniform(-1, 1) - 4, rng.uniform(-1, 1) - 2.5, rng.uniform(18, 22)])
        r = np.asarray(so3.exp(rvec), np.float64)
        uvw = (obj @ r.T + tvec) @ k_true.T
        views.append(uvw[:, :2] / uvw[:, 2:3])
    return np.stack(views).astype(np.float32), obj.astype(np.float32), k_true


def split_cloud(seed: int):
    """An item ellipsoid over a ground sheet plus outliers, at the bench
    scene's magnitudes (tests/test_gpu_device.py)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(1200, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    item = v * np.array([2.0, 1.5, 1.8]) + np.array([-5.2, -2.2, 3.0])
    sheet = np.column_stack([rng.uniform(-8, 10, 700), np.zeros(700), rng.uniform(-4, 26, 700)])
    outliers = rng.normal(size=(20, 3)) * 8 + np.array([-5.2, -6.0, 3.0])
    return np.concatenate([item, sheet, outliers]).astype(np.float32)


def on(jax, fn, device, *args, **kwargs):
    """``fn`` with its array arguments committed to ``device``."""
    placed = [jax.device_put(a, device) if isinstance(a, np.ndarray) else a for a in args]
    with jax.default_device(device):
        return jax.device_get(fn(*placed, **kwargs))


def phase_parity(
    jax,
    clahe_shapes=((20, 540, 960), (32, 180, 320)),
    clahe_cpu_frames: int = 4,
    hamming_shape=(4096, 256),
    ba_shape=(20, 8192),
) -> dict:
    from meatmodeler_tpu import volume
    from meatmodeler_tpu.geometry import calibration
    from meatmodeler_tpu.ops import clahe, matching
    from meatmodeler_tpu.solvers import bundle_adjust

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    out = {"phase": "parity"}

    for shape in clahe_shapes:
        img = rng.integers(0, 256, size=shape).astype(np.float32)
        served = on(jax, clahe.clahe, gpu, img)
        # The frames of a batch are independent (vmap); the CPU reference
        # checks the first few at full frame width.
        ref = on(jax, clahe.clahe, cpu, img[:clahe_cpu_frames])
        err = float(np.abs(served[:clahe_cpu_frames] - ref).max())
        out[f"clahe_{'x'.join(map(str, shape))}"] = {
            "max_abs": err, "atol": 1e-3,
            "why": "LUTs are integer-exact; only the bilinear float interpolation may round differently",
        }
        check(served.shape == shape and np.isfinite(served).all(), f"CLAHE {shape} output")
        check(err <= 1e-3, f"CLAHE {shape}: max |gpu - cpu| {err}")

    q = rng.integers(0, 2, size=hamming_shape).astype(np.int8)
    t = rng.integers(0, 2, size=hamming_shape).astype(np.int8)
    d_gpu = on(jax, matching.hamming_matrix, gpu, q, t)
    d_cpu = on(jax, matching.hamming_matrix, cpu, q, t)
    mismatches = int(np.sum(d_gpu != d_cpu))
    out["hamming_matrix"] = {
        "shape": [hamming_shape, hamming_shape], "mismatches": mismatches,
        "why": "bf16 {0,1} inputs, f32 accumulation, sums <= 256: exact",
    }
    check(mismatches == 0, f"hamming_matrix: {mismatches} entries differ")

    n_f, n_p = ba_shape
    prob = ring_problem(n_f, n_p, noise_px=0.5, seed=1)
    args = (prob["ext"], prob["k"], prob["pts0"], prob["obs"], prob["fidx"], prob["pidx"])
    rmse = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        _, _, res = on(jax, bundle_adjust.adjust_points, dev, *args)
        rmse[name] = float(res.rmse)
    rel = abs(rmse["gpu"] - rmse["cpu"]) / rmse["cpu"]
    out["adjust_points"] = {
        "cameras": n_f, "points": n_p, "observations": n_f * n_p,
        "rmse_px": rmse, "rel_diff": rel, "rel_tol": 0.01,
        "why": "LM iterates in float32 with sums in another order; 1% of RMSE",
    }
    check(np.isfinite(rmse["gpu"]) and rel <= 0.01, f"adjust_points RMSE {rmse}")

    views, obj, k_true = board_views(8, seed=6)
    focal = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        res = on(
            jax, calibration.calibrate, dev, views, obj,
            np.array([1920.0, 1080.0], np.float32), num_dist=0,
        )
        focal[name] = float(np.asarray(res.intrinsics)[0, 0])
    f_err = abs(focal["gpu"] - k_true[0, 0]) / k_true[0, 0]
    out["calibrate"] = {
        "board": [9, 6], "views": 8, "focal": focal, "focal_true": k_true[0, 0],
        "rel_err": f_err, "rel_tol": 0.01,
        "why": "exact projections: a 1% focal error is a solver fault, not noise",
    }
    check(f_err <= 0.01, f"calibrate focal {focal} vs {k_true[0, 0]}")

    pts = split_cloud(seed=11)
    mask = np.ones(len(pts), bool)
    split = {name: on(jax, volume.split_item_points, dev, pts, mask) for name, dev in (("gpu", gpu), ("cpu", cpu))}
    agree = float(np.mean(split["gpu"] == split["cpu"]))
    out["split_item_points"] = {
        "points": len(pts), "agreement": agree, "min_agreement": 0.99,
        "why": "gates sit on medians/MADs: a few borderline flips are float noise",
    }
    check(agree >= 0.99, f"split_item_points agreement {agree}")

    emit(out)
    return out


# ---------------------------------------------------------------------------
# ondevice_tests
# ---------------------------------------------------------------------------


class _Tally:
    """pytest plugin: counts test outcomes (setup skips included)."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}
        self.failed = []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1
            if report.outcome == "failed":
                self.failed.append(report.nodeid)


def phase_ondevice_tests() -> dict:
    import pytest

    os.environ["MEATMODELER_GPU_TESTS"] = "1"
    tally = _Tally()
    t0 = time.perf_counter()
    rc = pytest.main(
        [
            "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:xdist", "--durations=8",
            "--rootdir", str(REPO), str(REPO / "tests" / "test_gpu_device.py"),
        ],
        plugins=[tally],
    )
    out = {
        "phase": "ondevice_tests", "exit_code": int(rc), **tally.counts,
        "failed_tests": tally.failed, "seconds": time.perf_counter() - t0,
    }
    emit(out)
    check(int(rc) == 0, f"on-device tests exit code {int(rc)}")
    check(tally.counts["skipped"] == 0, "on-device tests skipped on the card")
    check(tally.counts["passed"] > 0, "no on-device test ran")
    return out


# ---------------------------------------------------------------------------
# e2e
# ---------------------------------------------------------------------------


def _summary(jax, label, result, scene, cold_s, warm_s, board: bool) -> dict:
    from meatmodeler_tpu.ops.chessboard import host_detector_available

    c = result.metrics["counters"]
    vol_err = abs(result.volume - scene.volume) / scene.volume
    return {
        "run": label,
        "keyframes": int(c["keyframes"]),
        "points": int(len(result.points)),
        "rmse_px": float(result.reprojection_rmse),
        "volume_err": float(vol_err) if board else None,
        "low_confidence": bool(result.volume_confidence["low_confidence"]),
        "markerless": bool(c.get("markerless", False)),
        "clahe": "xla",
        "pass1_backend": c.get("pass1_backend"),
        "board_bootstrap_detector": c.get("board_bootstrap_detector"),
        "board_detect_host_fallbacks": int(c.get("board_detect_host_fallbacks", 0)),
        "board_detect_host_skipped": int(c.get("board_detect_host_skipped", 0)),
        "board_probe_exhausted": c.get("board_probe_exhausted"),
        "opencv_importable": host_detector_available(),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "peak_bytes_in_use": peak_bytes(jax.devices()[0]),
        "stage_s": dict(result.metrics["timings"]),
    }


def _gate(s: dict, board: bool) -> None:
    label = s["run"]
    check(np.isfinite(s["rmse_px"]) and s["rmse_px"] <= RMSE_MAX_PX, f"{label}: rmse_px {s['rmse_px']}")
    if board:
        check(not s["markerless"], f"{label}: fell to the marker-free path")
        check(
            s["low_confidence"] or s["volume_err"] <= VOLUME_ERR_MAX,
            f"{label}: volume_err {s['volume_err']}",
        )
    else:
        check(s["markerless"], f"{label}: marker-free path did not engage")


def _timed_process(frames, config):
    from meatmodeler_tpu.pipeline import process

    t0 = time.perf_counter()
    process(frames, config=config)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = process(frames, config=config)
    return result, cold, time.perf_counter() - t0


def phase_e2e(
    jax,
    headline_frames: int = HEADLINE_FRAMES,
    scene=None,
    markerless_frames=None,
    mf_scene=None,
    batch_videos: int = BATCH_VIDEOS,
    batch_frames: int = BATCH_FRAMES,
    config=None,
) -> list:
    import bench
    from meatmodeler_tpu.io.synthetic import render_sequence
    from meatmodeler_tpu.parallel.batch import process_batch

    config = config or bench.bench_config()
    scene = scene or bench.get_scene()
    runs = []

    frames, _, _ = render_sequence(scene, headline_frames, seed=0, backend="jax")
    for label, cfg in (
        ("headline_host_pass1", config),
        ("device_pass1", dataclasses.replace(config, pass1_backend="device")),
    ):
        result, cold, warm = _timed_process(frames, cfg)
        s = _summary(jax, label, result, scene, cold, warm, board=True)
        emit({"phase": "e2e", **s})
        _gate(s, board=True)
        runs.append(s)
    kf_host, kf_dev = runs[0]["keyframes"], runs[1]["keyframes"]
    check(
        abs(kf_dev - kf_host) <= KEYFRAME_DENSITY_TOL,
        f"device pass-1 keyframes {kf_dev} vs host {kf_host}",
    )
    del frames

    mf_scene = mf_scene or bench.markerless_scene()
    mf_frames, _, _ = render_sequence(
        mf_scene, markerless_frames or bench.MF_FRAMES, seed=1, color=False, backend="jax"
    )
    mf_config = bench.markerless_config(mf_scene.focal, base=config)
    result, cold, warm = _timed_process(mf_frames, mf_config)
    s = _summary(jax, "markerless_known_focal", result, mf_scene, cold, warm, board=False)
    emit({"phase": "e2e", **s})
    _gate(s, board=False)
    runs.append(s)
    del mf_frames

    clips = [
        render_sequence(scene, batch_frames, seed=100 + i, backend="jax")[0]
        for i in range(batch_videos)
    ]
    t0 = time.perf_counter()
    process_batch(clips, config=config)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = process_batch(clips, config=config)
    warm = time.perf_counter() - t0
    per_clip = [
        _summary(jax, f"batch[{i}]", r, scene, None, None, board=True)
        for i, r in enumerate(results)
    ]
    keep = ("keyframes", "points", "rmse_px", "volume_err", "low_confidence", "markerless",
            "board_detect_host_fallbacks", "board_detect_host_skipped")
    s = {
        "run": f"batch_{batch_videos}x{batch_frames}",
        "clips": [{k: p[k] for k in keep} for p in per_clip],
        "clahe": "xla",
        "opencv_importable": per_clip[0]["opencv_importable"],
        "cold_s": cold, "warm_s": warm,
        "peak_bytes_in_use": peak_bytes(jax.devices()[0]),
    }
    emit({"phase": "e2e", **s})
    for p in per_clip:
        _gate(p, board=True)
    runs.append(s)
    return runs


# ---------------------------------------------------------------------------
# --four-gpu
# ---------------------------------------------------------------------------


def _close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(b), 1e-12)


def four_gpu(
    jax,
    n_devices: int = 4,
    batch_videos: int = BATCH_VIDEOS,
    batch_frames: int = BATCH_FRAMES,
    scene=None,
    config=None,
    ba_shape=(20, 8192),
) -> list:
    import bench
    from meatmodeler_tpu.config import SolverConfig
    from meatmodeler_tpu.io.synthetic import render_sequence
    from meatmodeler_tpu.parallel import sharded
    from meatmodeler_tpu.parallel.batch import process_batch
    from meatmodeler_tpu.parallel.pipelined import process_batch_pipelined
    from meatmodeler_tpu.pipeline import process
    from meatmodeler_tpu.solvers import bundle_adjust

    devices = jax.devices()[:n_devices]
    config = config or bench.bench_config()
    scene = scene or bench.get_scene()
    clips = [
        render_sequence(scene, batch_frames, seed=100 + i, backend="jax")[0]
        for i in range(batch_videos)
    ]
    out = []
    rel_tol = 1e-2
    vol_tol = 5e-2
    why_volume = ("the volume reads medians and order statistics of the solved "
                  "cloud, which float-level moves of the points shift by a few "
                  "percent, so within 5% (the quality gate allows 35% against truth)")

    def compare(label, ours, ref, seconds, why):
        rows = []
        for i, (a, b) in enumerate(zip(ours, ref)):
            rows.append({
                "clip": i,
                "points": [len(a.points), len(b.points)],
                "rmse_px": [a.reprojection_rmse, b.reprojection_rmse],
                "volume": [a.volume, b.volume],
            })
        line = {"phase": "four_gpu", "path": label, "devices": n_devices,
                "rmse_rel_tol": rel_tol, "volume_rel_tol": vol_tol,
                "why": f"{why}: the same points, RMSE within 1%; {why_volume}",
                "seconds_incl_compile": seconds, "clips": rows}
        emit(line)
        for r in rows:
            check(r["points"][0] == r["points"][1], f"{label} clip {r['clip']}: points {r['points']}")
            check(_close(*r["rmse_px"], rel_tol), f"{label} clip {r['clip']}: rmse {r['rmse_px']}")
            check(_close(*r["volume"], vol_tol), f"{label} clip {r['clip']}: volume {r['volume']}")
        out.append(line)

    # One call each; the seconds include compilation and are for
    # information only.
    mesh = sharded.make_mesh(data=n_devices, model=1)
    ref = process_batch(clips, config=config)
    t0 = time.perf_counter()
    ours = process_batch(clips, config=config, mesh=mesh)
    compare(f"process_batch_mesh_data{n_devices}", ours, ref, time.perf_counter() - t0,
            "each card solves its share of the batch, a program compiled for "
            "another batch shape, so sums run in another order")

    pair = clips[:2]
    seq = [process(c, config=config) for c in pair]
    t0 = time.perf_counter()
    pp = process_batch_pipelined(pair, config=config, devices=(devices[0], devices[1]))
    compare("process_batch_pipelined_gpu0_gpu1", pp, seq, time.perf_counter() - t0,
            "ingest and solve run as separate programs on two cards, "
            "so sums run in another order")

    n_f, n_p = ba_shape
    prob = ring_problem(n_f, n_p, noise_px=0.5, seed=1)
    args = [jax.device_put(prob[k], devices[0]) for k in ("ext", "k", "pts0", "obs", "fidx", "pidx")]
    rmse, pts = {}, {}
    for name, cfg in (("one_card", SolverConfig()), ("point_sharded", SolverConfig(point_shard_devices=n_devices))):
        new_pts, _, res = bundle_adjust.adjust_points(*args, config=cfg)
        rmse[name] = float(res.rmse)
        pts[name] = np.asarray(new_pts)
    pt_diff = float(np.abs(pts["point_sharded"] - pts["one_card"]).max())
    line = {
        "phase": "four_gpu", "path": f"adjust_points_point_shard_devices{n_devices}",
        "devices": n_devices, "cameras": n_f, "points": n_p, "rmse_px": rmse,
        "max_point_diff": pt_diff, "rmse_rel_tol": rel_tol,
        "why": "the camera system is psum-reduced across cards: RMSE within 1%",
    }
    emit(line)
    check(_close(rmse["point_sharded"], rmse["one_card"], rel_tol), f"point-sharded BA rmse {rmse}")
    out.append(line)
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four-gpu", action="store_true",
        help="run only the multi-device paths and their one-card counterparts, on four cards",
    )
    args = parser.parse_args(argv)

    import jax

    # Before anything compiles: JAX decides at its first compilation whether
    # a persistent cache is in use.
    from meatmodeler_tpu.utils import compile_cache

    compile_cache.configure()
    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: needs an NVIDIA GPU; JAX's default backend is "
            f"{jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 2

    n_devices = 4 if args.four_gpu else 1
    phase_device(jax, n_devices)
    if args.four_gpu:
        four_gpu(jax, n_devices=n_devices)
    else:
        phase_parity(jax)
        phase_ondevice_tests()
        phase_e2e(jax)

    devices = jax.devices()
    emit({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": n_devices if args.four_gpu else len(devices),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
