"""ctypes binding for the native host keyframe scan (native/pass1.cpp).

``config.pass1_backend="host"`` runs pass 1's keyframe selection entirely on
the host CPU: the same CLAHE -> pyramidal-LK -> error-accumulation ->
Shi-Tomasi-reseed state machine as the device scan
(``pipeline._make_keyframe_scan``), in scalar C++. Only *selected* keyframes
are then copied to the device, not the per-frame stream.

Statistical parity contract (SURVEY.md §7.3): keyframe *selection* matches
the device scan's density and placement, not bitwise flag-for-flag — both
are approximations of the reference's cv2 loop (``processor.py:61-110``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from meatmodeler_tpu.io._native_build import NativeLib

__all__ = ["HostPass1Scanner", "host_pass1_available"]


def _configure(lib, ct):
    f32p = ct.POINTER(ct.c_float)
    u8p = ct.POINTER(ct.c_uint8)
    lib.pass1_scan.argtypes = [
        u8p, ct.c_long, ct.c_long, ct.c_long,  # greys, t, h, w
        ct.c_long,  # bootstrap_at
        ct.c_float, ct.c_int, ct.c_int,  # clahe clip, tiles_y, tiles_x
        f32p, f32p, u8p, f32p, f32p,  # state: prev, pts, mask, acc, acc_flow
        ct.c_long, ct.c_float, ct.c_int, ct.c_int,  # K, quality, min_dist, block
        ct.c_int, ct.c_int, ct.c_int, ct.c_float,  # win, levels, iters, eps
        ct.c_float, ct.c_float,  # threshold_px, flow_threshold_px
        u8p, f32p,  # kf_flags, enhanced_out
    ]


_native = NativeLib(
    src=Path(__file__).resolve().parents[2] / "native" / "pass1.cpp",
    lib_path=Path(__file__).resolve().parent / "_libpass1.so",
    configure=_configure,
)


def host_pass1_available() -> bool:
    return _native.load() is not None


def _ptr(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


class HostPass1Scanner:
    """Carries the keyframe-scan state across chunks (one video's pass 1).

    Mirrors the device scan carry (pyramid, points, mask, accumulated error
    — ``pipeline._make_keyframe_scan``); the previous frame is stored
    CLAHE'd and pyramids rebuild per chunk inside the C++.
    """

    def __init__(self, config, h: int, w: int, full_width: int):
        lib = _native.load()
        if lib is None:
            raise RuntimeError(
                "pass1_backend='host' needs the native pass-1 library and no "
                "C++ toolchain is available; use pass1_backend='device'"
            )
        self._lib = lib
        kf = config.keyframe
        self._clahe = config.clahe
        self._kf = kf
        self._h, self._w = int(h), int(w)
        self._prev = np.zeros((h, w), np.float32)
        self._pts = np.zeros((kf.max_corners, 2), np.float32)
        self._mask = np.zeros(kf.max_corners, np.uint8)
        self._acc = np.zeros(1, np.float32)
        self._acc_flow = np.zeros(1, np.float32)
        # The keyframe rule thresholds against the FULL-resolution width
        # (processor.py:100 via pipeline's width_scale handling) — or, when
        # KeyframeConfig.threshold_abs is set, against that constant
        # intensity budget regardless of resolution or downscale.
        self._threshold_px = float(
            kf.threshold_abs if kf.threshold_abs > 0 else kf.threshold * full_width
        )
        # Secondary displacement trigger (KeyframeConfig.flow_threshold):
        # denominated against the WORKING width — displacement is measured
        # in working px, so the ratio is resolution/downscale-invariant.
        self._flow_threshold_px = float(kf.flow_threshold * w)
        self.initialized = False

    def scan(self, greys: np.ndarray, bootstrap_at: int = -1):
        """Scan a (T, h, w) uint8 chunk; returns (flags bool (T,), enhanced
        float32 (T, h, w) — meaningful at flagged/bootstrap frames)."""
        greys = np.ascontiguousarray(greys, dtype=np.uint8)
        t = len(greys)
        assert greys.shape[1:] == (self._h, self._w), greys.shape
        flags = np.zeros(t, np.uint8)
        enhanced = np.zeros((t, self._h, self._w), np.float32)
        kf, cl = self._kf, self._clahe
        self._lib.pass1_scan(
            _ptr(greys, ctypes.c_uint8), t, self._h, self._w,
            int(bootstrap_at),
            float(cl.clip_limit), int(cl.tile_grid[0]), int(cl.tile_grid[1]),
            _ptr(self._prev, ctypes.c_float), _ptr(self._pts, ctypes.c_float),
            _ptr(self._mask, ctypes.c_uint8), _ptr(self._acc, ctypes.c_float),
            _ptr(self._acc_flow, ctypes.c_float),
            kf.max_corners, float(kf.quality_level), int(kf.min_distance),
            int(kf.block_size),
            int(kf.window), int(kf.pyramid_levels), int(kf.max_iters),
            float(kf.eps),
            self._threshold_px, self._flow_threshold_px,
            _ptr(flags, ctypes.c_uint8), _ptr(enhanced, ctypes.c_float),
        )
        if bootstrap_at >= 0:
            self.initialized = True
        return flags.astype(bool), enhanced
