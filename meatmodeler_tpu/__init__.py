"""meatmodeler_tpu — a JAX Structure-from-Motion and volume-estimation
framework for NVIDIA GPUs with the capabilities of skyepurchase/MeatModeler.

Public API mirrors the reference's entry points:
  * ``process(video, path, ...)`` — end-to-end video -> point cloud + volume
    (``processor.py:294``), fixing the reference's broken promise of a return
    value (``processor.py:303``: docstring promises a cloud, returns None).
  * ``adjust_points(...)`` / ``adjust_pose(...)`` — the bundle-adjuster entry
    points (``bundleAdjuster.py:160, 214``).
  * ``Track`` — compatibility view over the SoA track store (``track.py:1``).
"""

__version__ = "0.1.0"

from meatmodeler_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    PipelineConfig,
)


def __getattr__(name):
    # Lazy exports: keep `import meatmodeler_tpu` light (no jax import) so
    # config handling and CLI help stay instant.
    if name in ("process", "ProcessResult"):
        from meatmodeler_tpu import pipeline

        return getattr(pipeline, name)
    if name in ("adjust_points", "adjust_pose", "solve_ba", "BAProblem", "BAResult"):
        from meatmodeler_tpu import solvers

        return getattr(solvers, name)
    if name == "Track":
        from meatmodeler_tpu.tracks import Track

        return Track
    raise AttributeError(f"module 'meatmodeler_tpu' has no attribute {name!r}")
