"""YUV420 8-bit frame IO + PSNR, preserving the reference's exact semantics.

Mirrors the behavior (not the code) of `inference/yuv_data.{h,cpp}` and the
Python-side readers (`training/yuv_data.py`, `training/train_data.py`):

- a YUV420p frame is H*W luma bytes followed by H*W/2 chroma bytes; the
  engine reads ONLY the Y plane and seeks past UV (yuv_data.cpp:32-38).
- PSNR is computed in double precision as 10*log10(65025/mse) — 65025 ==
  255^2 kept as the literal constant the reference uses (yuv_data.cpp:87-97).
- the recon writer emits a gray (zero) UV plane (yuv_data.cpp:113-128).

A C++ fast path for bulk Y-plane extraction and PSNR lives in
qcnn_gpu.native; these NumPy versions are the portable fallback and the
semantics definition.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def frame_size_420(height: int, width: int) -> int:
    return height * width * 3 // 2


def read_y(
    path: str, height: int, width: int, frames: Optional[int] = None, start: int = 0
) -> np.ndarray:
    """Read Y planes of a YUV420p file -> uint8 [frames, H, W].

    `start` skips whole frames first (cf. read_frame's fseek,
    yuv_data.cpp:44-66). frames=None reads to EOF. Uses the native C++
    reader when available (qcnn_gpu.native); this NumPy path is the
    fallback and semantic definition.
    """
    if frames is not None:
        from qcnn_gpu import native

        out = native.read_y(path, height, width, frames, start)
        if out is not None:
            return out
    fsz = frame_size_420(height, width)
    ysz = height * width
    out = []
    with open(path, "rb") as fp:
        if start:
            fp.seek(start * fsz)
        n = 0
        while frames is None or n < frames:
            buf = fp.read(ysz)
            if len(buf) < ysz:
                if frames is not None:
                    raise EOFError(
                        f"{path}: wanted {frames} frames, got {n} "
                        f"({height}x{width})"
                    )
                break
            out.append(np.frombuffer(buf, dtype=np.uint8).reshape(height, width))
            fp.seek(ysz // 2, 1)  # skip UV
            n += 1
    if not out:
        raise EOFError(f"{path}: empty")
    return np.stack(out)


def write_y_as_420(path: str, y: np.ndarray) -> None:
    """Write uint8 [frames, H, W] luma with a gray UV plane per frame."""
    frames, h, w = y.shape
    uv = np.zeros(h * w // 2, dtype=np.uint8)
    with open(path, "wb") as fp:
        for i in range(frames):
            fp.write(np.ascontiguousarray(y[i], dtype=np.uint8).tobytes())
            fp.write(uv.tobytes())


def psnr(a: np.ndarray, ref: np.ndarray) -> float:
    """10*log10(65025/mse) over all pixels, double accumulation
    (yuv_data.cpp:87-97). Returns +inf for identical inputs."""
    diff = a.astype(np.float64) - ref.astype(np.float64)
    mse = float(np.mean(diff * diff))
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(65025.0 / mse)


def psnr_per_frame(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-frame PSNR for [frames, H, W] stacks (yuv_data.cpp:98-112)."""
    diff = a.astype(np.float64) - ref.astype(np.float64)
    mse = np.mean(diff * diff, axis=(1, 2))
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(65025.0 / mse)
