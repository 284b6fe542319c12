"""XProf/XSpace trace summarization: per-program device seconds.

The reference's only observability is wall-clock prints (SURVEY.md §5.1);
``utils.profiling.profile_run`` already captures full XProf traces. This
module turns a capture into NUMBERS the bench artifact can carry: seconds of
actual device execution per XLA program (module), separating device compute
from host orchestration — wall-clock alone cannot tell a host-stalled stage
from a compute-bound one.

Implementation: traces are ``*.xplane.pb`` protobufs (one ``XSpace`` of
``XPlane`` rows per host/device). The schema ships with the installed
tensorflow's ``tsl/profiler/protobuf/xplane_pb2.py``, which is loaded
STANDALONE via importlib (importing all of tensorflow costs ~10 s and pulls
CUDA shims; the generated module itself needs only ``google.protobuf``).
No tensorflow = summarizer degrades to ``None``, never an ImportError.

Device planes are named ``/device:<PLATFORM>:<N>``. Where a device plane
has an ``XLA Modules`` line (one event per executable run, named after the
jitted function) it is summed; otherwise every line of the plane is summed,
which double-counts a GPU's concurrent streams (ROADMAP lists the GPU
reduction as open). On CPU (the test backend) XLA runs inside host
threadpool lines instead; the summarizer falls back to aggregating those.
"""

from __future__ import annotations

import glob
import importlib.util
import os
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["device_time_summary"]

_XPLANE_PB2_CANDIDATES = (
    "tensorflow/tsl/profiler/protobuf/xplane_pb2.py",
    "tensorflow/compiler/tsl/profiler/protobuf/xplane_pb2.py",
)

_pb2 = None


def _load_pb2():
    """Load xplane_pb2 straight from its file, skipping the tensorflow
    package import."""
    global _pb2
    if _pb2 is not None:
        return _pb2
    import site

    roots = list(site.getsitepackages()) + [
        os.path.dirname(os.path.dirname(os.__file__))
    ]
    for root in roots:
        for rel in _XPLANE_PB2_CANDIDATES:
            path = os.path.join(root, rel)
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location("xplane_pb2", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _pb2 = mod
                return mod
    return None


def _clean(name: str) -> str:
    """'jit_solve_ba(fused)...' / 'jit_run.5' -> stable short key."""
    name = name.split("(")[0]
    # Strip XLA's uniquifying numeric suffix but keep the function name.
    parts = name.rsplit(".", 1)
    if len(parts) == 2 and parts[1].isdigit():
        name = parts[0]
    return name


def device_time_summary(trace_dir: str) -> Optional[Dict]:
    """Summarize the newest ``*.xplane.pb`` under ``trace_dir``.

    Returns ``{"plane": str, "total_device_s": float,
    "modules": {program_name: seconds}}`` — seconds of device execution per
    XLA program, and their sum (the trace window's device busy time) — or
    ``None`` when no trace/parser is available. Never raises.
    """
    try:
        pb2 = _load_pb2()
        if pb2 is None:
            return None
        paths = sorted(
            glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
            key=os.path.getmtime,
        )
        if not paths:
            return None
        space = pb2.XSpace()
        with open(paths[-1], "rb") as f:
            space.ParseFromString(f.read())

        def aggregate(plane, line_filter):
            per: Dict[str, float] = defaultdict(float)
            for line in plane.lines:
                if not line_filter(line.name):
                    continue
                for ev in line.events:
                    md = plane.event_metadata[ev.metadata_id]
                    per[_clean(md.name)] += ev.duration_ps / 1e12
            return dict(per)

        # Prefer a real device plane ("XLA Modules" = one event per program
        # execution — exactly the per-program accounting we want).
        for plane in space.planes:
            if "/device:" in plane.name and "CPU" not in plane.name:
                per = aggregate(plane, lambda n: "XLA Modules" in n)
                if not per:  # some runtimes emit only per-op lines
                    per = aggregate(plane, lambda n: True)
                if per:
                    return {
                        "plane": plane.name,
                        "total_device_s": round(sum(per.values()), 4),
                        "modules": {
                            k: round(v, 4)
                            for k, v in sorted(per.items(), key=lambda kv: -kv[1])
                        },
                    }
        # CPU fallback: XLA executions run on client threadpool host lines.
        for plane in space.planes:
            if plane.name.startswith("/host:"):
                per = aggregate(
                    plane, lambda n: "XLAPjRtCpuClient" in n or "PjRt" in n
                )
                if per:
                    return {
                        "plane": plane.name,
                        "total_device_s": round(sum(per.values()), 4),
                        "modules": {
                            k: round(v, 4)
                            for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:40]
                        },
                    }
        return None
    except Exception:  # pragma: no cover — diagnostics must never break a run
        return None
