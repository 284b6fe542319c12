"""Test bootstrap: force an 8-device virtual CPU backend before JAX loads.

Standard JAX fake-backend trick (SURVEY.md §4): all sharded tests run on a
virtual CPU mesh so the suite is hardware-independent.

``MEATMODELER_GPU_TESTS=1`` leaves the GPU visible for the ``gpu``-marked
on-device subset (``tests/test_gpu_device.py``), which ``chip_smoke.py``
runs in its own process on the card; pyproject's default addopts
(``-m 'not gpu'``) keep that subset out of normal runs.
"""

import os

_GPU_MODE = os.environ.get("MEATMODELER_GPU_TESTS", "") == "1"

if not _GPU_MODE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    # f64 available for oracle comparisons (the solvers themselves run f32).
    os.environ["JAX_ENABLE_X64"] = "1"


# Persistent XLA compilation cache for the CPU test backend: repeat runs
# reuse the programs an earlier run compiled. The same rule as the program's
# (meatmodeler_tpu/utils/compile_cache.py): a directory named by
# JAX_COMPILATION_CACHE_DIR wins; otherwise a fixed one under .cache/.
#
# KEYED PER MACHINE: XLA's CPU AOT loader does not key cache entries on the
# host's CPU features — an entry compiled on a machine with (say) AMX/
# prefer-no-gather loads on a host without them and can die with SIGILL
# mid-suite (observed: cpu_aot_loader.cc "Target machine feature ... is not
# supported on the host machine", then a fatal crash). Hashing the cpuinfo
# flags into the directory name gives each machine class its own cache.
def _machine_tag() -> str:
    import hashlib

    # Hash flags AND model name: XLA keys some target features (e.g.
    # +prefer-no-gather, a microcode-erratum mitigation) on the CPU MODEL,
    # not on cpuinfo feature flags — two hosts with identical flags can still
    # disagree on the AOT target (observed: cpu_aot_loader "+prefer-no-gather
    # is not supported on the host machine" from a flags-only-keyed cache).
    try:
        keys = []
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "model name")):
                    keys.append(line.strip())
                    if len(keys) == 2:
                        break
        if keys:
            return hashlib.sha256("\n".join(sorted(set(keys))).encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.processor().encode()).hexdigest()[:8]


if not _GPU_MODE and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".cache", f"jax-cpu-{_machine_tag()}")
    )

import jax  # noqa: E402

from meatmodeler_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()

# Bound in-process XLA/LLVM state: after ~45 min of suite accumulation the
# CPU backend segfaulted NATIVELY (inside backend_compile_and_load) while
# compiling the vmapped shard_map BA program — reproducibly at the same
# test in two full runs, while the same test passes in a fresh process and
# in any shorter subset. Dropping the jit caches between test modules keeps
# the resident-executable population small; the persistent disk cache makes
# the re-loads cheap.
import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
    gc.collect()
