"""Host (native C++) pass-1 keyframe scan vs the device lax.scan program.

The host backend (``config.pass1_backend="host"``, ``native/pass1.cpp``)
runs the identical selection state machine — CLAHE, Shi-Tomasi reseed,
pyramidal LK, the reference's error accumulation rule
(``processor.py:95-106``) — in scalar C++ so only selected keyframes cross
the host->device link. Contract: statistical parity of the *selection*
(density and placement), exact parity of everything downstream.
"""

import dataclasses

import numpy as np
import pytest

from meatmodeler_tpu.config import DEFAULT_CONFIG, KeyframeConfig
from meatmodeler_tpu.io.native_pass1 import HostPass1Scanner, host_pass1_available
from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu import pipeline as pipeline_mod

pytestmark = pytest.mark.skipif(
    not host_pass1_available(), reason="no C++ toolchain for native pass 1"
)

SCENE = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)


@pytest.fixture(scope="module")
def clip():
    frames, _, _ = render_sequence(SCENE, 32, seed=1)
    return np.asarray(frames)


def _device_flags(greys, config, width):
    import jax.numpy as jnp

    init_carry, scan_chunk = pipeline_mod._make_keyframe_scan(config)
    enhanced = pipeline_mod._clahe_grey_batch(jnp.asarray(greys))
    carry = init_carry(enhanced[0])
    flags = []
    # width_scale multiplies the downscaled width back to full resolution.
    _, f = scan_chunk(carry, enhanced[1:], width_scale=width // greys.shape[2])
    flags = np.asarray(f)
    return flags


class TestHostScanParity:
    def test_keyframe_selection_matches_device_scan(self, clip):
        config = dataclasses.replace(
            DEFAULT_CONFIG,
            keyframe=dataclasses.replace(KeyframeConfig(), threshold=0.02),
        )
        scale = 2
        greys = native_ops.bgr_to_grey_down(clip, scale)
        dev = _device_flags(greys, config, clip.shape[2])

        scanner = HostPass1Scanner(
            config, greys.shape[1], greys.shape[2], full_width=clip.shape[2]
        )
        host, enhanced = scanner.scan(greys, bootstrap_at=0)
        host = host[1:]  # device flags start at frame 1 (frame 0 seeds)

        # Selection parity: same density (+-1) and each host keyframe within
        # 2 frames of a device keyframe (accumulated float error crosses the
        # threshold on the same frame up to rounding).
        nd, nh = int(dev.sum()), int(host.sum())
        assert abs(nd - nh) <= 1, (nd, nh)
        di, hi = np.nonzero(dev)[0], np.nonzero(host)[0]
        for h in hi:
            assert np.min(np.abs(di - h)) <= 2, (di, hi)

    def test_clahe_matches_xla_oracle(self, clip):
        from meatmodeler_tpu.ops import clahe

        greys = native_ops.bgr_to_grey_down(clip[:1], 2)
        scanner = HostPass1Scanner(
            DEFAULT_CONFIG, greys.shape[1], greys.shape[2], full_width=clip.shape[2]
        )
        _, enhanced = scanner.scan(greys, bootstrap_at=0)
        oracle = np.asarray(clahe.clahe(greys[0].astype(np.float32)))
        # Statistical parity (SURVEY §7.3.4): mean within a grey level.
        assert np.mean(np.abs(enhanced[0] - oracle)) < 1.0

    def test_state_carries_across_chunks(self, clip):
        """Scanning in two chunks must flag the same keyframes as one call
        (the carry — points, mask, accumulated error, previous frame — is
        the whole point of the state machine)."""
        config = dataclasses.replace(
            DEFAULT_CONFIG,
            keyframe=dataclasses.replace(KeyframeConfig(), threshold=0.02),
        )
        greys = native_ops.bgr_to_grey_down(clip, 2)
        one = HostPass1Scanner(config, greys.shape[1], greys.shape[2], clip.shape[2])
        f_one, _ = one.scan(greys, bootstrap_at=0)

        two = HostPass1Scanner(config, greys.shape[1], greys.shape[2], clip.shape[2])
        f_a, _ = two.scan(greys[:16], bootstrap_at=0)
        f_b, _ = two.scan(greys[16:])
        np.testing.assert_array_equal(f_one, np.concatenate([f_a, f_b]))


@pytest.mark.slow
class TestHostPipelineParity:
    def test_full_pipeline_matches_device_backend(self, clip):
        """End-to-end: identical keyframes -> identical downstream results
        (board detect, ORB, BA all consume the same uploaded keyframes)."""
        from tests.test_pipeline import TEST_CONFIG

        cfg_dev = dataclasses.replace(TEST_CONFIG, pass2_enhance="grey")
        cfg_host = dataclasses.replace(cfg_dev, pass1_backend="host")
        rd = pipeline_mod.process(clip, config=cfg_dev)
        rh = pipeline_mod.process(clip, config=cfg_host)
        cd, ch = rd.metrics["counters"], rh.metrics["counters"]
        assert abs(ch["keyframes"] - cd["keyframes"]) <= 2, (
            ch["keyframes"], cd["keyframes"],
        )
        assert rh.reprojection_rmse < 1.5 * max(rd.reprojection_rmse, 0.5)
        assert 0.5 * len(rd.points) < len(rh.points) < 2.0 * len(rd.points)
