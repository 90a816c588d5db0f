"""Useful-work accounting and the GPU peak table (engine/mfu.py)."""

import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.engine.mfu import (
    USEFUL_MACS_PER_PX,
    chip_peaks,
    mfu_report,
)

H100_SXM = "NVIDIA H100 80GB HBM3"


def test_useful_macs_match_topology():
    # SURVEY §0 table: C1 + C2_1 + C2_2 + C3_1 + C3_2 + C4
    assert USEFUL_MACS_PER_PX == 1600 + 18432 + 25600 + 6912 + 1536 + 432


def test_chip_peaks_lookup():
    # NVIDIA H100 data sheet, SXM, dense: int8 TOP/s, bf16 TFLOP/s, TB/s
    assert chip_peaks(H100_SXM) == (1979.0, 989.0, 3.35)


@pytest.mark.parametrize(
    "kind", ["cpu", "", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "nvidia h100 80gb hbm3"]
)
def test_unknown_device_kind_raises(kind):
    """No default: a device without a published row is an error."""
    with pytest.raises(ValueError, match="no published peaks"):
        chip_peaks(kind)


def test_mfu_report_consistency():
    r = mfu_report(1920 * 1080, 2.51, H100_SXM)
    # 54512 MACs/px * 2.07 Mpx / 2.51 ms * 2 ops/MAC = ~90.0 TOP/s
    assert r["sustained_useful_tops"] == pytest.approx(90.0, abs=0.5)
    assert r["util_vs_int8_peak"] == pytest.approx(r["sustained_useful_tops"] / 1979, abs=1e-4)
    assert r["util_vs_bf16_peak"] == pytest.approx(2 * r["util_vs_int8_peak"], abs=1e-3)


def test_mfu_report_unknown_device_raises():
    with pytest.raises(ValueError):
        mfu_report(1920 * 1080, 2.51, "cpu")
