"""Structured per-stage metrics and timing.

The reference's only observability is interleaved prints + tic/toc
(``processor.py:305-489``, SURVEY.md §5.1/§5.5). Here each pipeline stage
records wall-clock and counters into a dict that ``process`` returns, and a
``trace`` context manager wraps stages in ``jax.profiler``-visible named
scopes for XProf/Perfetto traces.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict

logger = logging.getLogger("meatmodeler")

__all__ = ["Metrics", "trace", "logger", "device_barrier"]

# JAX dispatch is async: a stage's wall-clock normally measures enqueue time,
# with the compute billed to whichever later stage first blocks. Setting
# MEATMODELER_SYNC_STAGES=1 drains the device at every stage exit so timings
# attribute truthfully (at the cost of losing cross-stage overlap).
_SYNC_STAGES = os.environ.get("MEATMODELER_SYNC_STAGES", "") not in ("", "0")


def device_barrier() -> None:
    """Block until all work enqueued so far on the default device finishes.

    The device runs its executables in dispatch order on one compute
    stream, so blocking on a fresh trivial computation drains that stream
    (pinned on the GPU by ``tests/test_gpu_device.py``).
    """
    import jax
    import jax.numpy as jnp

    (jnp.zeros(()) + 0.0).block_until_ready()


class Metrics:
    """Accumulates per-stage wall times and arbitrary counters."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, Any] = {}
        self._pending: Dict[str, Any] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with trace(name):
            yield
            if _SYNC_STAGES:
                device_barrier()
        dt = time.perf_counter() - t0
        self.timings[name] = self.timings.get(name, 0.0) + dt
        logger.info("%s: %.3fs", name, dt)

    def count(self, name: str, value) -> None:
        self.counters[name] = value
        logger.info("%s = %s", name, value)

    def add(self, name: str, value) -> None:
        """Accumulating counter (``count`` overwrites)."""
        self.counters[name] = self.counters.get(name, 0) + value

    def count_async(self, name: str, value, convert=None) -> None:
        """Defer a device-resident counter — no readback here.

        A device->host sync stalls the host until the device catches up, and
        a metrics-only scalar never justifies one mid-pipeline. The device
        value is held and materialized in ONE batch at ``flush()`` /
        ``as_dict()`` (after the pipeline's last required sync). ``convert``
        maps the fetched ndarray to its recorded form (default: ``.item()``
        for scalars, ``.tolist()`` otherwise).
        """
        self._pending[name] = (value, convert)

    def flush(self) -> None:
        """Materialize all deferred counters (one batched readback)."""
        if not self._pending:
            return
        import jax

        pending, self._pending = self._pending, {}
        # ONE device_get for the whole batch: per-value np.asarray would pay
        # one device round trip each.
        values = jax.device_get([v for v, _ in pending.values()])
        for (name, (_, convert)), v in zip(pending.items(), values):
            if convert is not None:
                out = convert(v)
            elif getattr(v, "ndim", 0) == 0:
                out = v.item()
            else:
                out = v.tolist()
            self.counters[name] = out
            logger.info("%s = %s", name, out)

    def as_dict(self) -> Dict[str, Any]:
        self.flush()
        return {"timings": dict(self.timings), "counters": dict(self.counters)}


@contextlib.contextmanager
def trace(name: str):
    """jax named scope + profiler annotation (no-op cost when not profiling)."""
    import jax

    with jax.named_scope(name), jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_run():
    """Capture a full XProf/Perfetto device trace of the enclosed run when
    ``MEATMODELER_PROFILE=<dir>`` is set (view with xprof/tensorboard or
    ui.perfetto.dev). The per-stage ``trace`` annotations above become
    named slices inside the capture. No-op otherwise."""
    out_dir = os.environ.get("MEATMODELER_PROFILE")
    if not out_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", out_dir)
