"""Color conversion + CLAHE golden tests vs OpenCV (SURVEY.md §4)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meatmodeler_tpu.ops import clahe as clahe_mod
from meatmodeler_tpu.ops import color


def random_image(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    # Smooth-ish image with gradients + noise (CLAHE behaves differently on
    # flat vs textured regions; cover both).
    yy, xx = np.mgrid[0:h, 0:w]
    base = 80 + 60 * np.sin(yy / 17.0) + 40 * np.cos(xx / 23.0)
    img = np.clip(base + rng.normal(scale=12, size=(h, w)), 0, 255)
    return img.astype(np.uint8)


class TestColor:
    def test_bgr_to_grey_matches_cv2(self):
        rng = np.random.default_rng(1)
        bgr = rng.integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
        expected = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY).astype(np.float32)
        ours = np.asarray(color.bgr_to_grey(bgr))
        # cv2 rounds to uint8; we stay float.
        assert np.abs(ours - expected).max() <= 0.51

    def test_bgr_to_lab_matches_cv2(self):
        rng = np.random.default_rng(2)
        bgr = rng.integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
        expected = cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB).astype(np.float32)
        ours = np.asarray(color.bgr_to_lab(bgr))
        diff = np.abs(ours - expected)
        # cv2 computes LAB via quantized integer LUTs; worst cases near the
        # CIE knee (very dark pixels) differ by ~2 levels. Hold the mean
        # tight and the max to the LUT-quantization envelope.
        assert diff.mean() < 0.5, diff.mean()
        assert diff.max() <= 2.5, diff.max()

    def test_lab_round_trip(self):
        rng = np.random.default_rng(3)
        bgr = rng.integers(10, 246, size=(32, 32, 3)).astype(np.float32)
        back = np.asarray(color.lab_to_bgr(color.bgr_to_lab(bgr)))
        assert np.abs(back - bgr).max() < 1.0


class TestClahe:
    def test_matches_cv2_statistically(self):
        img = random_image()
        expected = cv2.createCLAHE(clipLimit=3.5, tileGridSize=(8, 8)).apply(img)
        ours = np.asarray(clahe_mod.clahe(img.astype(np.float32)))
        diff = np.abs(ours - expected.astype(np.float32))
        # Statistical parity (SURVEY.md §7.3.4): interpolation details differ,
        # hold mean to ~1 grey level and the bulk of pixels to a few levels.
        assert diff.mean() < 1.5, diff.mean()
        assert np.percentile(diff, 95) < 4.0, np.percentile(diff, 95)

    def test_odd_size_padding(self):
        img = random_image(h=101, w=137, seed=4)
        out = np.asarray(clahe_mod.clahe(img.astype(np.float32)))
        assert out.shape == (101, 137)
        assert np.isfinite(out).all()
        assert out.min() >= 0 and out.max() <= 255

    def test_batch(self):
        imgs = np.stack([random_image(seed=s) for s in range(3)]).astype(np.float32)
        out = np.asarray(clahe_mod.clahe(imgs))
        assert out.shape == imgs.shape
        single = np.asarray(clahe_mod.clahe(imgs[1]))
        np.testing.assert_allclose(out[1], single)

    def test_flat_image_unchanged_mostly(self):
        img = np.full((64, 64), 128.0, np.float32)
        out = np.asarray(clahe_mod.clahe(img))
        # Equalizing a constant image must not invent structure.
        assert np.abs(out - out.mean()).max() < 1.0

    def test_enhanced_grey_pipeline_vs_cv2(self):
        """Full increaseContrast + grey path (processor.py:12-26,357)."""
        rng = np.random.default_rng(5)
        base = random_image(96, 128, seed=6)
        bgr = np.stack([
            np.clip(base + rng.normal(scale=8, size=base.shape), 0, 255),
            np.clip(base * 0.8 + 30, 0, 255),
            np.clip(base * 1.1, 0, 255),
        ], axis=-1).astype(np.uint8)

        lab = cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB)
        l, a, b = cv2.split(lab)
        l_out = cv2.createCLAHE(clipLimit=3.5, tileGridSize=(8, 8)).apply(l)
        enhanced = cv2.cvtColor(cv2.merge((l_out, a, b)), cv2.COLOR_LAB2BGR)
        expected = cv2.cvtColor(enhanced, cv2.COLOR_BGR2GRAY).astype(np.float32)

        ours = np.asarray(clahe_mod.enhanced_grey(bgr))
        diff = np.abs(ours - expected)
        # Four chained stages each quantized to uint8 inside cv2 but kept
        # float here compound to a few grey levels of drift; hold the mean to
        # that envelope and require near-perfect structural correlation
        # (what downstream corner detectors actually consume).
        assert diff.mean() < 4.0, diff.mean()
        corr = np.corrcoef(ours.ravel(), expected.ravel())[0, 1]
        assert corr > 0.995, corr

