"""YUV420 IO + PSNR semantics."""

import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

import math

import numpy as np

from qcnn_gpu.data import yuv
from qcnn_gpu.testing import synth_frames


def test_roundtrip(tmp_path):
    y = synth_frames(3, 24, 32)
    path = str(tmp_path / "clip.yuv")
    yuv.write_y_as_420(path, y)
    back = yuv.read_y(path, 24, 32)
    assert (back == y).all()
    # frame count / UV skip honored
    two = yuv.read_y(path, 24, 32, frames=2)
    assert (two == y[:2]).all()
    last = yuv.read_y(path, 24, 32, frames=1, start=2)
    assert (last[0] == y[2]).all()


def test_file_size_is_420(tmp_path):
    import os

    y = synth_frames(2, 16, 16)
    path = str(tmp_path / "c.yuv")
    yuv.write_y_as_420(path, y)
    assert os.path.getsize(path) == 2 * yuv.frame_size_420(16, 16)


def test_psnr_constant_65025():
    a = np.zeros((1, 8, 8), np.uint8)
    b = np.full((1, 8, 8), 5, np.uint8)
    # mse = 25 -> psnr = 10*log10(65025/25)
    assert yuv.psnr(a, b) == 10 * math.log10(65025.0 / 25.0)
    assert yuv.psnr(a, a) == math.inf


def test_psnr_per_frame():
    a = np.zeros((2, 8, 8), np.uint8)
    b = a.copy()
    b[1] += 10
    pf = yuv.psnr_per_frame(a, b)
    assert pf[0] == math.inf
    assert pf[1] == 10 * math.log10(65025.0 / 100.0)
