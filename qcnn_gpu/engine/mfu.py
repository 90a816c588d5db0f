"""Useful-work and roofline accounting for the QVRCNN pipeline.

The reference's whole INT8x4/cuDNN configuration exists to feed the GPU's
tensor units (mat.cuh:39-101); this module says how much of the card's
published peak the restoration sustains.

Useful MACs per pixel (the network as defined, SURVEY.md §0 topology —
NOT the merged/zero-padded convs the engine issues):
    C1 5x5x1x64=1600, C2_1 3x3x64x32=18432, C2_2 5x5x64x16=25600,
    C3_1 3x3x48x16=6912, C3_2 1x1x48x32=1536, C4 3x3x48x1=432

Peaks are keyed by jax's `device_kind`. A device that is not in the table
raises: a utilization against a guessed peak is no number at all.
"""

from __future__ import annotations

from typing import Dict, Tuple

USEFUL_MACS_PER_PX = 1600 + 18432 + 25600 + 6912 + 1536 + 432  # = 54512

# device_kind -> (int8 dense TOP/s, bf16 dense TFLOP/s, HBM TB/s).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM column, dense rates
# (without sparsity), at the SXM part's 700 W limit.
_PEAKS: Dict[str, Tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (1979.0, 989.0, 3.35),
}


def chip_peaks(device_kind: str) -> Tuple[float, float, float]:
    """(int8 TOP/s, bf16 TFLOP/s, HBM TB/s) of the device; ValueError if
    its peaks are not in the table."""
    try:
        return _PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add a row "
            "with its source to qcnn_gpu/engine/mfu.py _PEAKS"
        ) from None


def mfu_report(px_per_frame: int, ms_per_frame: float, device_kind: str) -> Dict:
    """Sustained useful TOP/s of the whole restoration against the card's
    int8 and bf16 peaks (end-to-end utilization, not a kernel's roofline
    share)."""
    macs_per_s = USEFUL_MACS_PER_PX * px_per_frame / (ms_per_frame * 1e-3)
    tops = 2 * macs_per_s / 1e12
    int8_peak, bf16_peak, hbm_tbs = chip_peaks(device_kind)
    return {
        "device_kind": device_kind,
        "useful_macs_per_px": USEFUL_MACS_PER_PX,
        "sustained_useful_tops": round(tops, 2),
        "peak_tops_int8": int8_peak,
        "peak_tflops_bf16": bf16_peak,
        "peak_hbm_tbs": hbm_tbs,
        "util_vs_int8_peak": round(tops / int8_peak, 4),
        "util_vs_bf16_peak": round(tops / bf16_peak, 4),
    }
