"""Trace-time matmul-precision pinning for numerics-critical code.

On the GPU, float32 ``jnp.dot``/``@``/``einsum`` default to TF32 tensor-core
passes, which keep about three decimal digits (a 10-bit mantissa). That is
the right trade for the image path (CLAHE LUT application, ORB matching's
Hamming matmul — large, precision-insensitive), but it is catastrophic for
the GEOMETRY path: Gauss-Newton normal equations square the condition
number, so three-digit matmuls turn LM solves into random walks (on exact
observations a reduced-precision pose solve stalls at a third of a pixel of
residual with the damping railed at 1e12; with HIGHEST it reaches ~0 like
the CPU backend), and TF32 rounding (relative 2**-11) of a 1500 px focal
times a rotation moves a projection by up to about a pixel.

``matmul_highp`` wraps a function so that every jnp operation created
while its Python body runs — i.e. while it is being TRACED, standalone or
inlined inside any outer ``jit`` — defaults to ``lax.Precision.HIGHEST``
(full float32). The geometry matrices are tiny (3x3 blocks, 8-point
systems, reduced camera systems of tens of rows), so full precision is free
at the pipeline scale.

On the CPU backend float32 matmuls are full precision anyway; there the
wrapper is a no-op in effect. The config still participates in jit cache
keys, which is why the wrapper is applied at function level, not flipped
globally: the image-path programs must keep compiling at DEFAULT.
"""

from __future__ import annotations

import functools
import os

import jax

__all__ = ["matmul_highp"]

# Debug escape hatch: MEATMODELER_NO_HIGHP=1 makes the wrapper a no-op, so
# a numeric difference can be A/B'd against the backend's default matmul
# precision without touching call sites. Read once at import.
_DISABLED = os.environ.get("MEATMODELER_NO_HIGHP", "") == "1"


def matmul_highp(fn):
    """Run ``fn`` (and anything it inlines) under HIGHEST matmul precision.

    The context is entered whenever the Python body executes, which for
    jitted callers is exactly trace time — nested application is harmless.
    """
    if _DISABLED:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
