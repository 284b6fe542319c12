"""Rules that hold on every backend: CLAHE is one XLA program, the compile
cache lives where the environment or the repo says, the benchmark's peak
table knows only published GPU rates, and ``chip_smoke.py`` refuses to run
without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest

from meatmodeler_tpu.ops import clahe as clahe_mod
from meatmodeler_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, env_extra=None, env_drop=(), cwd=REPO, timeout=240):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for k in env_drop:
        env.pop(k, None)
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _textured(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 90 + 50 * np.sin(yy / 13.0) + 40 * np.cos(xx / 29.0)
    img = base + rng.normal(scale=10, size=shape)
    return np.clip(img, 0, 255).astype(np.uint8)


class TestClaheServed:
    # The pass-1 shape (1080p / 6), the pass-2 keyframe shape (1080p / 2),
    # and shapes whose tile heights/widths are odd or fractional (padded).
    @pytest.mark.parametrize(
        "shape,tiles",
        [
            ((2, 180, 320), (8, 8)),
            ((1, 540, 960), (8, 8)),
            ((2, 91, 133), (8, 8)),
            ((1, 120, 168), (7, 5)),
        ],
    )
    def test_matches_opencv_at_pipeline_shapes(self, shape, tiles):
        """The frame is padded bottom/right by reflection to whole tiles,
        then equalized as OpenCV equalizes the padded frame. (OpenCV itself
        pads a whole extra tile along an axis that divides evenly when the
        other does not, so at 180x320 it would use another tile width.)"""
        img = _textured(shape)
        ours = np.asarray(clahe_mod.clahe(img.astype(np.float32), tiles=tiles))
        assert ours.shape == shape
        # The bilinear apply runs in float: a hair past 255 is rounding.
        assert np.isfinite(ours).all() and ours.min() >= 0 and ours.max() < 255.01
        ty, tx = tiles
        h, w = shape[-2:]
        pad = ((0, 0), (0, -h % ty), (0, -w % tx))
        padded = np.pad(img, pad, mode="reflect")
        cl = cv2.createCLAHE(clipLimit=3.5, tileGridSize=(tx, ty))
        ref = np.stack([cl.apply(f)[:h, :w] for f in padded]).astype(np.float32)
        diff = np.abs(ours - ref)
        # OpenCV rounds to uint8; the interpolation here stays float.
        assert diff.mean() < 0.3, diff.mean()
        assert diff.max() <= 1.0, diff.max()

    def test_one_xla_program_without_kernels(self):
        """No hand-written kernel and no backend dispatch: the program is
        the same plain XLA on every backend."""
        x = np.zeros((2, 180, 320), np.float32)
        text = jax.jit(clahe_mod.clahe).lower(x).as_text()
        assert "pallas" not in text and "custom_call" not in text
        assert "pallas" not in str(jax.make_jaxpr(clahe_mod.clahe)(x))

    def test_batch_is_per_frame(self):
        """Frames of a batch are independent: the batched call equals the
        per-frame calls (chip_smoke compares a batch prefix on the CPU)."""
        img = _textured((3, 96, 128), seed=4).astype(np.float32)
        batched = np.asarray(clahe_mod.clahe(img))
        single = np.stack([np.asarray(clahe_mod.clahe(f)) for f in img])
        np.testing.assert_array_equal(batched, single)


class TestCompileCache:
    def test_environment_directory_wins(self):
        assert compile_cache.directory_to_set({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) is None

    def test_default_is_fixed_repo_directory(self):
        d = compile_cache.directory_to_set({})
        assert d == str(REPO / ".cache" / "jax")
        # Nothing per process, backend or time in it.
        assert d == compile_cache.directory_to_set({"JAX_PLATFORMS": "gpu"})
        assert str(os.getpid()) not in d and "cpu" not in d and "gpu" not in d

    def test_empty_environment_value_means_unset(self):
        d = compile_cache.directory_to_set({"JAX_COMPILATION_CACHE_DIR": ""})
        assert d == str(REPO / ".cache" / "jax")

    def test_set_directory_receives_the_cache(self, tmp_path):
        code = (
            "import jax, jax.numpy as jnp\n"
            "from meatmodeler_tpu.utils import compile_cache\n"
            "print(compile_cache.configure())\n"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
        )
        r = _run(code, env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == str(tmp_path)
        assert any(tmp_path.iterdir()), "nothing was written to the cache"

    def test_unset_uses_repo_directory(self):
        code = (
            "from meatmodeler_tpu.utils import compile_cache\n"
            "print(compile_cache.configure())\n"
        )
        r = _run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == str(REPO / ".cache" / "jax")

    def test_importing_the_pipeline_initialises_no_backend(self):
        """Importing must not reserve the card: no backend is created
        before the caller's first computation."""
        code = (
            "import meatmodeler_tpu.pipeline, meatmodeler_tpu.parallel.batch\n"
            "import meatmodeler_tpu.cli, meatmodeler_tpu.odometry, meatmodeler_tpu.two_view\n"
            "import meatmodeler_tpu.parallel.pipelined, meatmodeler_tpu.parallel.sharded\n"
            "from jax._src import xla_bridge\n"
            "print(len(xla_bridge._backends))\n"
        )
        r = _run(code)
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == "0"


class TestPeakTable:
    def test_h100_has_its_published_rate(self):
        import bench

        assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", ""])
    def test_unknown_device_has_no_peak(self, kind):
        import bench

        assert bench.peak_flops(kind) is None


class TestChipSmokeRefuses:
    def _assert_refused(self, r):
        assert r.returncode != 0
        for line in r.stdout.splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            assert not (isinstance(obj, dict) and "ok" in obj), line

    def test_without_a_gpu(self):
        self._assert_refused(_run(["chip_smoke.py"]))

    def test_four_gpu_without_a_gpu(self):
        self._assert_refused(_run(["chip_smoke.py", "--four-gpu"]))

    def test_alone_without_the_repo(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        self._assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))


class TestChipSmokeGates:
    """The quality gates chip_smoke holds each end-to-end run to."""

    def _run(self, **kw):
        s = {"run": "t", "rmse_px": 0.5, "markerless": False,
             "low_confidence": False, "volume_err": 0.1}
        s.update(kw)
        return s

    @pytest.fixture(scope="class")
    def smoke(self):
        sys.path.insert(0, str(REPO))
        import chip_smoke

        return chip_smoke

    def test_good_board_run_passes(self, smoke):
        smoke._gate(self._run(), board=True)

    @pytest.mark.parametrize(
        "bad",
        [
            {"rmse_px": 1.2},
            {"rmse_px": float("nan")},
            {"markerless": True},
            {"volume_err": 0.5},
        ],
    )
    def test_bad_board_run_fails(self, smoke, bad):
        with pytest.raises(smoke.CheckFailed):
            smoke._gate(self._run(**bad), board=True)

    def test_low_confidence_excuses_volume_only(self, smoke):
        smoke._gate(self._run(volume_err=0.5, low_confidence=True), board=True)
        with pytest.raises(smoke.CheckFailed):
            smoke._gate(self._run(rmse_px=2.0, low_confidence=True), board=True)

    def test_markerless_run_must_be_markerless(self, smoke):
        smoke._gate(self._run(markerless=True, volume_err=None), board=False)
        with pytest.raises(smoke.CheckFailed):
            smoke._gate(self._run(volume_err=None), board=False)
