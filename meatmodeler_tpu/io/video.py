"""Host-side frame sources feeding the device pipeline.

The reference reads frames one at a time through ``cv2.VideoCapture``
(``processor.py:310-319, 354, 415``). Video decode is inherently host work
(SURVEY.md §2.4); the change here is *batching*: frames are decoded in
chunks sized for the device's scan-based keyframe pass (``pipeline.py``),
instead of round-tripping per frame.

Accepted sources: a path to any cv2-decodable video, a path to a ``.npy``
array, a path to a ``.y4m`` file (decoded by the native C++ loader when
built, NumPy otherwise), or an in-memory ndarray (T, H, W[, 3]).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Union

import numpy as np

__all__ = ["FrameSource"]


class FrameSource:
    """Uniform chunked access to video frames as BGR uint8 arrays."""

    def __init__(self, source: Union[str, Path, np.ndarray]):
        self._frames = None
        self._cap = None
        if isinstance(source, np.ndarray):
            self._frames = self._normalize(source)
        else:
            path = Path(source)
            if path.suffix == ".npy":
                self._frames = self._normalize(np.load(path))
            elif path.suffix == ".y4m":
                from meatmodeler_tpu.io import y4m

                self._frames = self._normalize(y4m.read_y4m(path))
            else:
                try:
                    import cv2
                except ImportError as e:
                    raise ImportError(
                        f"decoding {path.suffix or 'this'} video containers "
                        f"needs OpenCV (cv2), which is not installed; pass "
                        f"frames as a .npy or .y4m file or a numpy array"
                    ) from e

                self._cap = cv2.VideoCapture(str(path))
                if not self._cap.isOpened():
                    raise FileNotFoundError(f"cannot open video: {source}")

    @staticmethod
    def _normalize(arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 3:  # grey -> BGR
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.dtype == np.uint8:
            # No up-front copy: uint8 sources (including np.load mmaps) are
            # consumed chunk-by-chunk, so a whole-video astype/contiguous
            # copy here would cost seconds of host time for nothing.
            return arr
        return np.ascontiguousarray(arr.astype(np.uint8))

    def chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        """Yield (<=chunk_size, H, W, 3) uint8 BGR chunks until exhausted."""
        if self._frames is not None:
            for i in range(0, len(self._frames), chunk_size):
                yield self._frames[i : i + chunk_size]
            return

        done = False
        while not done:
            buf = []
            for _ in range(chunk_size):
                ok, frame = self._cap.read()
                if not ok:
                    done = True
                    break
                buf.append(frame)
            if buf:
                yield np.stack(buf)
