"""Pipeline parallelism: stage the video pipeline across devices.

SURVEY.md §2.5 marks PP as the one strategy with no analog in the reference
(which has no parallelism of any kind) and sketches its shape:
"stage the pipeline (decode -> detect -> match -> solve) across devices".
This module implements that as a two-stage software pipeline over a stream
of videos:

  stage 1 (ingest, device A):  decode -> pass-1 keyframe scan -> board
    detection -> ORB/matching/tracks -> calibration/PnP/pose-BA — everything
    up to the global solve (``pipeline._reconstruct_to_ba``).
  stage 2 (solve, device B):  global Schur BA -> volume -> PLY
    (``pipeline._solve_and_finish``).

While video i's global BA runs on device B, video i+1's ingest runs on
device A — the classic 1F1B overlap, driven by two host threads and a
bounded queue (JAX dispatch is async per device, so the two streams only
serialize on their own device's queue). Complements the other strategies:
DP (``parallel.batch`` — independent per-core BA solves), TP
(``parallel.sharded.match_descriptors_tp``), SP
(``parallel.sharded.preprocess_sharded``).
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import jax
import numpy as np

from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu.pipeline import ProcessResult, _reconstruct_to_ba, _solve_and_finish
from meatmodeler_tpu.utils import Metrics
from meatmodeler_tpu.utils.checkpoint import StageCheckpointer

__all__ = ["process_batch_pipelined"]


def process_batch_pipelined(
    videos: Sequence,
    config: PipelineConfig = DEFAULT_CONFIG,
    devices: Optional[Sequence] = None,
    paths: Optional[Sequence[Optional[str]]] = None,
    known_corners: Optional[Sequence[Optional[np.ndarray]]] = None,
    queue_depth: int = 2,
) -> List[ProcessResult]:
    """Reconstruct a stream of videos with ingest and solve pipelined
    across two devices.

    Args:
      videos: sequence of video sources (paths or (T, H, W, 3) arrays).
      config: shared config tree.
      devices: two jax devices (ingest, solve). Defaults to the first and
        last of ``jax.devices()`` (same-device degrades gracefully to the
        sequential schedule).
      paths: optional per-video output prefixes.
      known_corners: optional per-video ground-truth board corners.
      queue_depth: bound on in-flight PreBA handoffs (backpressure).

    Returns:
      One ProcessResult per video, in input order.
    """
    n = len(videos)
    paths = paths if paths is not None else [None] * n
    known_corners = known_corners if known_corners is not None else [None] * n
    if devices is None:
        devs = jax.devices()
        devices = (devs[0], devs[-1])
    d_ingest, d_solve = devices

    metrics_list = [Metrics() for _ in range(n)]
    results: List[Optional[ProcessResult]] = [None] * n
    errors: List[BaseException] = []
    handoff: "queue.Queue" = queue.Queue(maxsize=queue_depth)

    def ingest_worker():
        try:
            for i, video in enumerate(videos):
                with jax.default_device(d_ingest):
                    pre = _reconstruct_to_ba(
                        video, config, known_corners[i], metrics_list[i],
                        StageCheckpointer(None),
                    )
                handoff.put((i, pre))
        except BaseException as e:  # surface on the main thread
            errors.append(e)
        finally:
            handoff.put(None)

    def solve_worker():
        try:
            while True:
                item = handoff.get()
                if item is None:
                    return
                i, pre = item
                with jax.default_device(d_solve):
                    # Move the solver inputs to the solve device explicitly;
                    # host-side numpy members transfer on first use.
                    pre = pre._replace(
                        ext_refined=jax.device_put(pre.ext_refined, d_solve),
                        intrinsics=jax.device_put(pre.intrinsics, d_solve),
                        dist=jax.device_put(pre.dist, d_solve),
                    )
                    results[i] = _solve_and_finish(
                        pre, config, metrics_list[i], StageCheckpointer(None), paths[i]
                    )
        except BaseException as e:
            errors.append(e)
            # Keep draining so the ingest producer never blocks on a full
            # queue after this stage has died (bounded queue = deadlock
            # otherwise); remaining videos are dropped, the first error is
            # re-raised on the caller's thread.
            while handoff.get() is not None:
                pass

    from meatmodeler_tpu.utils.profiling import profile_run

    with profile_run():  # MEATMODELER_PROFILE=<dir> captures both stages
        t_solve = threading.Thread(target=solve_worker)
        t_solve.start()
        ingest_worker()
        t_solve.join()
    if errors:
        raise errors[0]
    assert all(r is not None for r in results)
    return results  # type: ignore[return-value]
