"""Shared test/bench fixtures: synthesized-but-realistic engine parameters.

The reference repo ships quant tables and golden PSNRs but NOT the int8
weight files (they lived on a lab machine, kernel.cu:7-10). So tests and
benchmarks synthesize weights on the int8 grid from the REAL per-QP quant
tables (assets/quant_params*.data), giving realistic blu_q/mul/shift ranges
and weight magnitudes while keeping everything self-contained.
"""

from __future__ import annotations

import os

import numpy as np

from qcnn_gpu.models.oracle import DynamicParams, EngineParams
from qcnn_gpu.models.topology import QVRCNN_LAYERS, weight_shape_hwio
from qcnn_gpu.quant.params import QuantTable

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def asset(name: str) -> str:
    return os.path.join(ASSETS_DIR, name)


def load_table(qp: int = 37) -> QuantTable:
    return QuantTable.load_pickle(asset(f"quant_params{qp}.data"))


def synth_float_weights(seed: int = 0, scale: float = 0.06):
    """He-ish float weights + small biases, shaped per topology."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for layer in QVRCNN_LAYERS:
        shape = weight_shape_hwio(layer)
        fan_in = layer.ksize * layer.ksize * layer.in_ch
        w = rng.normal(0.0, scale / np.sqrt(fan_in / 25.0), size=shape).astype(
            np.float32
        )
        b = rng.normal(0.0, 0.01, size=(layer.out_ch,)).astype(np.float32)
        ws.append(w)
        bs.append(b)
    return ws, bs


def synth_engine_params(qp: int = 37, seed: int = 0) -> EngineParams:
    """EngineParams with the real QP table and synthesized int8 weights.

    fixed_last_row() repairs QP22's stale shift=24 output row (which would
    zero the residual, see QuantTable.last_row_stale); the other QPs pass
    through unchanged."""
    table = load_table(qp).fixed_last_row()
    ws, bs = synth_float_weights(seed)
    return EngineParams.from_float(ws, bs, table)


def synth_dynamic_params(qp: int = 37, seed: int = 0) -> DynamicParams:
    """DynamicParams (stepw, w, b) for the calibration path."""
    rng = np.random.default_rng(seed + 1)
    table = load_table(qp)
    ws, bs = synth_float_weights(seed)
    p = EngineParams.from_float(ws, bs, table)
    # integer stepw as the dynamic format stores it (cnn.cu:78): a small
    # positive per-layer integer scale
    step_w = [int(rng.integers(2, 30)) for _ in range(6)]
    return DynamicParams(step_w, p.weights, p.biases)


def synth_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Plausible video-ish frames: smooth gradients + blocky noise, uint8."""
    rng = np.random.default_rng(seed + 2)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        128
        + 60 * np.sin(yy / 37.0)[None]
        + 50 * np.cos(xx / 53.0)[None]
        + rng.normal(0, 12, size=(n, h, w))
    )
    block = rng.integers(-6, 7, size=(n, (h + 7) // 8, (w + 7) // 8))
    base = base + np.kron(block, np.ones((1, 8, 8)))[:, :h, :w]
    return np.clip(base, 0, 255).astype(np.uint8)
