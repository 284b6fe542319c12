"""The main path without OpenCV: with ``import cv2`` failing, the bootstrap
board hunt runs the on-device detector, the board path still serves, and
the counters say which detector started the scan."""

import dataclasses
import sys

import numpy as np
import pytest

from meatmodeler_tpu.config import (
    DEFAULT_CONFIG,
    KeyframeConfig,
    MatcherConfig,
    OrbConfig,
    TrackConfig,
    VolumeConfig,
)
from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.ops import chessboard
from meatmodeler_tpu.pipeline import process

CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    keyframe=dataclasses.replace(KeyframeConfig(), max_corners=256, threshold=0.02),
    orb=OrbConfig(num_features=768, num_levels=2),
    matcher=MatcherConfig(max_matches=512),
    tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
    volume=VolumeConfig(voxel_resolution=48),
    frame_chunk=8,
)
SCENE = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(SCENE, 40, seed=0)[0]


@pytest.fixture
def no_cv2(monkeypatch):
    # A None entry makes ``import cv2`` raise ImportError.
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_host_detector_availability_follows_the_import(monkeypatch):
    assert chessboard.host_detector_available()
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not chessboard.host_detector_available()
    with pytest.raises(ImportError):
        chessboard.find_chessboard(np.zeros((60, 80), np.uint8), (9, 6))


@pytest.mark.parametrize("backend", ["host", "device"])
def test_board_path_without_opencv(no_cv2, frames, backend):
    cfg = dataclasses.replace(CONFIG, pass1_backend=backend)
    result = process(frames, config=cfg)
    c = result.metrics["counters"]
    assert c["board_bootstrap_detector"] == "device"
    assert c["pass1_backend"] == backend
    assert not c.get("markerless", False)
    assert "board_probe_exhausted" not in c
    assert c["keyframes"] >= 3
    assert c.get("board_detect_host_fallbacks", 0) == 0
    assert result.reprojection_rmse < 2.0
    assert abs(result.volume - SCENE.volume) / SCENE.volume < 0.35


def test_opencv_present_keeps_the_host_hunt(frames):
    result = process(frames, config=dataclasses.replace(CONFIG, pass1_backend="host"))
    c = result.metrics["counters"]
    assert c["board_bootstrap_detector"] == "host"
    assert not c.get("markerless", False)


def test_video_container_without_opencv_says_why(no_cv2, tmp_path):
    from meatmodeler_tpu.io.video import FrameSource

    path = tmp_path / "clip.mp4"
    path.write_bytes(b"")
    with pytest.raises(ImportError, match="OpenCV"):
        FrameSource(path)
