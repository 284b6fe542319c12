"""CLAHE's share of the pipeline's time on the GPU, read from a profiler trace.

    python tools/clahe_trace.py [--out .cache/clahe_trace]

Runs ``process`` on the 300-frame 1080p bench clip (``bench.py``) in the
headline configuration (host pass 1) and with ``pass1_backend="device"``:
one untimed run to compile, then one run under ``jax.profiler``. For each
run it prints one JSON line with the wall time of the traced run, the
device-busy time (union of kernel intervals on the GPU plane), the device
time of the CLAHE programs (XLA modules whose name contains "clahe") and
CLAHE's share of wall time, plus the ten largest modules. A second figure
needs no trace attribution: the device time of ``clahe`` alone, timed at
the shapes each run feeds it, times the number of calls. Needs a GPU; the
trace files stay under ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _union_seconds(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def gpu_device_time(xplane_path: str) -> dict:
    """Per-module device seconds and device-busy seconds of GPU 0.

    A kernel event is attributed to its XLA module through the event's
    ``hlo_module`` stat; the derived "XLA Modules"/"XLA Ops" lines, where
    the trace has them, are left out of both sums so no kernel counts twice.
    """
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    plane = next((p for p in data.planes if p.name == "/device:GPU:0"), None)
    if plane is None:
        raise RuntimeError(f"no /device:GPU:0 plane in {xplane_path}")
    per_module = defaultdict(float)
    intervals = []
    lines = {}
    sample = []
    for line in plane.lines:
        events = list(line.events)
        lines[line.name] = len(events)
        if line.name.startswith("XLA "):
            continue
        for ev in events:
            stats = dict(ev.stats)
            if len(sample) < 3:
                sample.append({"line": line.name, "event": ev.name, "stats": sorted(stats)})
            module = str(stats.get("hlo_module", "?"))
            per_module[module] += ev.duration_ns / 1e9
            intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    return {
        "sample_events": sample,
        "lines": lines,
        "busy_s": _union_seconds(intervals),
        "modules": dict(sorted(per_module.items(), key=lambda kv: -kv[1])),
    }


def standalone_clahe_s(jax, shape, calls: int, reps: int = 20) -> float:
    """Seconds of ``calls`` CLAHE calls on ``shape``, timed on the device."""
    import numpy as np

    from meatmodeler_tpu.ops import clahe

    x = jax.device_put(np.random.default_rng(0).integers(0, 256, shape).astype(np.float32))
    clahe.clahe(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = clahe.clahe(x)
    y.block_until_ready()
    return (time.perf_counter() - t0) / reps * calls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(REPO / ".cache" / "clahe_trace"))
    args = parser.parse_args(argv)

    import jax

    from meatmodeler_tpu.utils import compile_cache

    compile_cache.configure()
    if jax.default_backend() != "gpu":
        print("clahe_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import bench
    from meatmodeler_tpu.io.synthetic import render_sequence
    from meatmodeler_tpu.pipeline import process

    frames, _, _ = render_sequence(bench.get_scene(), bench.N_FRAMES, seed=0, backend="jax")
    config = bench.bench_config()
    h, w = frames.shape[1:3]
    for label, cfg in (
        ("headline_host_pass1", config),
        ("device_pass1", dataclasses.replace(config, pass1_backend="device")),
    ):
        process(frames, config=cfg)  # compile
        trace_dir = os.path.join(args.out, label)
        jax.profiler.start_trace(trace_dir)
        t0 = time.perf_counter()
        try:
            result = process(frames, config=cfg)
        finally:
            wall = time.perf_counter() - t0
            jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
        summary = gpu_device_time(path)
        clahe_s = sum(
            s for m, s in summary["modules"].items()
            if "clahe" in m.lower() or "enhanced_grey" in m.lower()
        )
        counters = result.metrics["counters"]
        # Pass 2 enhances the keyframes at the pass-2 scale in minibatches;
        # the device pass 1 also enhances every frame at the pass-1 scale.
        p2 = max(cfg.pass2_downscale, 1)
        shapes = {"pass2": ((int(counters["keyframes"]), h // p2, w // p2), 1)}
        if cfg.pass1_backend == "device":
            p1 = max(cfg.pass1_downscale, 1)
            chunks = -(-len(frames) // cfg.frame_chunk)
            shapes["pass1"] = ((cfg.frame_chunk, h // p1, w // p1), chunks)
        alone = {k: standalone_clahe_s(jax, shp, n) for k, (shp, n) in shapes.items()}
        print(json.dumps({
            "run": label,
            "wall_s": wall,
            "standalone_clahe_s": alone,
            "standalone_clahe_share_of_wall": sum(alone.values()) / wall,
            "device_busy_s": summary["busy_s"],
            "clahe_device_s": clahe_s,
            "clahe_share_of_wall": clahe_s / wall,
            "gpu_plane_lines": summary["lines"],
            "sample_events": summary["sample_events"],
            "top_modules_s": dict(list(summary["modules"].items())[:10]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
