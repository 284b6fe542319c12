"""Numerics guarding: NaN/Inf detection at stage boundaries and inside jits.

SURVEY.md §5.2/§5.3: the reference's only numerical defenses are scattered
``np.nan_to_num`` clamps (``processor.py:95``, ``bundleAdjuster.py:21,131``)
— a NaN anywhere else propagates silently into the cloud. The
equivalents here:

  * ``check_finite(stage, **arrays)`` — host-side gate at pipeline stage
    boundaries. No-op unless ``MEATMODELER_CHECK_NUMERICS=1`` (it forces a
    device sync); when on, a non-finite value raises :class:`NumericsError`
    naming the stage, the array, and the count — instead of surfacing as a
    garbage PLY file three stages later.
  * ``checked(fn)`` — wraps a jittable function with
    ``jax.experimental.checkify`` float checks, locating the *operation*
    that produced the first NaN/Inf inside the compiled program. This is the
    debug tool for kernels/solvers (compile cost roughly doubles; use on
    demand, not in production paths).
"""

from __future__ import annotations

import functools
import os

import numpy as np

__all__ = ["NumericsError", "checks_enabled", "check_finite", "checked"]


class NumericsError(RuntimeError):
    """A pipeline stage produced NaN/Inf values."""


def checks_enabled() -> bool:
    return os.environ.get("MEATMODELER_CHECK_NUMERICS", "") not in ("", "0")


def check_finite(stage: str, **arrays) -> None:
    """Raise NumericsError if any named array contains NaN/Inf.

    Active only when ``MEATMODELER_CHECK_NUMERICS=1`` — the check
    materializes device arrays on host, so it is a debug mode, not a
    production path.
    """
    if not checks_enabled():
        return
    for name, a in arrays.items():
        x = np.asarray(a)
        if not np.issubdtype(x.dtype, np.floating):
            continue
        bad = ~np.isfinite(x)
        n_bad = int(bad.sum())
        if n_bad:
            idx = np.argwhere(bad)[:4].tolist()
            raise NumericsError(
                f"stage '{stage}': array '{name}' has {n_bad}/{x.size} "
                f"non-finite values (first at indices {idx})"
            )


def checked(fn):
    """Wrap a jittable function with checkify float checks (NaN/Inf/div0).

    The wrapped function raises ``jax.experimental.checkify.JaxRuntimeError``
    pinpointing the first failing operation. Works through ``jit``,
    ``lax.scan`` / ``while_loop`` / ``cond``.
    """
    from jax.experimental import checkify

    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return run
