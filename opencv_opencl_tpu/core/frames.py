"""Frame layout types: NV12 / I420 views, batched frame buffers.

The reference moves raw NV12 byte buffers between GStreamer and its workers
and builds ``cv::Mat`` *views* over the mapped Y/UV regions rather than
copying (``nextimprovement.cpp:162-168``).  The device equivalent: frames are
numpy/JAX arrays with explicit plane views, and batched stacks of frames are
first-class so the device always sees large, static-shaped arrays.

Conventions
-----------
- An NV12 buffer is ``uint8[(H*3//2, W)]``: Y plane rows [0,H), then H/2
  rows of interleaved UV (U at even columns, V at odd).
- An I420 buffer is ``uint8[(H*3//2, W)]``: Y plane, then the U and V
  quarter planes packed row-major.
- A batch of frames adds a leading axis: ``uint8[(N, H*3//2, W)]``.
- ``CHROMA_GRAY`` zeroes color (UV=128) exactly like the reference's
  ``memset(uv, 128, ...)`` (``OpenCVequalHist.cpp:162``); ``CHROMA_PASS``
  copies the source chroma through (``improvement.cpp:162-163``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

__all__ = [
    "ChromaPolicy",
    "FrameFormat",
    "FrameSpec",
    "nv12_y",
    "nv12_uv",
    "split_nv12",
    "join_nv12",
    "gray_uv",
    "nv12_size",
]


class ChromaPolicy(str, enum.Enum):
    """What to do with the UV plane when only Y is enhanced."""

    GRAY = "gray"  # UV := 128 (reference OpenCVequalHist.cpp:162)
    PASSTHROUGH = "passthrough"  # UV copied from input (improvement.cpp:162-163)


class FrameFormat(str, enum.Enum):
    NV12 = "NV12"
    I420 = "I420"
    GRAY = "GRAY8"
    BGR = "BGR"


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static geometry of a video stream (width, height, fps, format).

    The analogue of the reference's cached ``GstVideoInfo``
    (``OpenCVequalHist.cpp:80-87``): captured once from caps, then reused for
    every frame so the hot path never re-parses geometry.
    """

    width: int
    height: int
    fps: float = 30.0
    fmt: FrameFormat = FrameFormat.NV12

    def __post_init__(self) -> None:
        if self.width % 2 or self.height % 2:
            raise ValueError(f"even dimensions required, got {self.width}x{self.height}")

    @property
    def y_size(self) -> int:
        return self.width * self.height

    @property
    def uv_size(self) -> int:
        return self.width * self.height // 2

    @property
    def buffer_size(self) -> int:
        """Bytes per NV12/I420 frame (the reference's y_size+uv_size check,
        ``OpenCVequalHist.cpp:129-137``)."""
        return self.y_size + self.uv_size

    @property
    def buffer_rows(self) -> int:
        return self.height * 3 // 2

    @property
    def frame_duration_s(self) -> float:
        return 1.0 / self.fps if self.fps > 0 else 0.0


def nv12_size(width: int, height: int) -> int:
    return width * height * 3 // 2


def nv12_y(buf: np.ndarray, height: int | None = None) -> np.ndarray:
    """Zero-copy view of the Y plane of an (..., H*3/2, W) NV12 buffer."""
    rows = buf.shape[-2]
    h = height if height is not None else rows * 2 // 3
    return buf[..., :h, :]


def nv12_uv(buf: np.ndarray, height: int | None = None) -> np.ndarray:
    """Zero-copy view of the interleaved UV rows of an NV12 buffer."""
    rows = buf.shape[-2]
    h = height if height is not None else rows * 2 // 3
    return buf[..., h:, :]


def split_nv12(buf: np.ndarray, height: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    return nv12_y(buf, height), nv12_uv(buf, height)


def join_nv12(y: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Concatenate Y and UV plane(s) back into an NV12 buffer.

    Works for single frames (2-D) and batches (3-D) alike.
    """
    if y.shape[:-2] != uv.shape[:-2] or y.shape[-1] != uv.shape[-1]:
        raise ValueError(f"incompatible planes: {y.shape} vs {uv.shape}")
    return np.concatenate([y, uv], axis=-2)


def gray_uv(spec: FrameSpec, batch: int | None = None) -> np.ndarray:
    """A constant UV plane of 128s — the GRAY chroma policy."""
    shape = (spec.height // 2, spec.width)
    if batch is not None:
        shape = (batch,) + shape
    return np.full(shape, 128, dtype=np.uint8)
