"""Calibration — from float checkpoint to static INT8 engine tables.

The reference's calibration story (SURVEY.md §3.3/§3.6): run the dynamic
path to record accumulator maxima (`save_steps`, qvrcnn.cu:70-81,163),
observe 3-sigma activation statistics on the float model (the blu_init
comments, quantization.py:69-76), then solve the fixed-point tables
offline (quantNsave). Both modes are reproduced:

  * calibrate_blu_bounds   — 3-sigma activation stats -> BLU upper bounds
  * solve_table            — stepw from weights + BLU bounds -> QuantTable
  * quantize_model         — float params + table -> integer EngineParams
  * calibrate_dynamic      — dynamic-oracle telemetry (max_u per layer)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from qcnn_gpu.models import float_model as FM
from qcnn_gpu.models.oracle import DynamicParams, EngineParams, forward_calibrate
from qcnn_gpu.quant.params import QuantTable
from qcnn_gpu.quant.solver import BLU_INIT, solve_network, stepw_from_weights


def calibrate_blu_bounds(
    params: FM.Params, sample_frames: np.ndarray, n_sigma: float = 3.0
) -> List[float]:
    """BLU upper bounds as n_sigma * std of each layer's pre-activation on
    sample data — how the reference's per-QP blu_init tables were obtained
    ('observed 3sigma', quantization.py:70). The float convs run at
    precision=HIGHEST: a GPU's default f32 conv rounds operands to TF32
    (~3 decimal digits), which would move the solved table with the device."""
    import jax

    with jax.default_matmul_precision("highest"):
        sigmas = FM.activation_sigmas(params, sample_frames)
    return [n_sigma * s for s in sigmas[:5]] + [0.0]


def solve_table(
    params: FM.Params,
    blu_bounds: Optional[Sequence[float]] = None,
    qp: Optional[int] = None,
    wbits: int = 8,
    per_channel: bool = False,
) -> QuantTable:
    """Fixed-point table from float weights; blu_bounds from calibration or
    the reference's per-QP presets. wbits=4 solves for the INT4 stretch
    grid (larger stepw; the mul/shift chain adapts automatically).
    per_channel=True gives every output channel its own stepw and
    (mul, shift), equalized to a common output scale — the INT4 quality
    closure (quant/solver.solve_network_per_channel)."""
    if blu_bounds is None:
        if qp is None:
            raise ValueError("need blu_bounds or qp")
        blu_bounds = BLU_INIT[qp]
    ws, _ = FM.params_to_lists(params)
    ws = [np.asarray(w) for w in ws]
    if per_channel:
        from qcnn_gpu.quant.solver import (
            solve_network_per_channel,
            stepw_per_channel,
        )

        return solve_network_per_channel(
            stepw_per_channel(ws, bits=wbits), blu_bounds
        )
    return solve_network(stepw_from_weights(ws, bits=wbits), blu_bounds)


def quantize_model(params: FM.Params, table: QuantTable, wbits: int = 8) -> EngineParams:
    """Float params -> integer engine params on the signed `wbits` grid."""
    ws, bs = FM.params_to_lists(params)
    return EngineParams.from_float(
        [np.asarray(w) for w in ws], [np.asarray(b) for b in bs], table, wbits=wbits
    )


def save_b_adj(path: str, b_adj: Sequence[np.ndarray]) -> None:
    """Append the six adjusted bias vectors to a binary telemetry file —
    the save_b_adj dump (qvrcnn.cu:288-304): fwrite of each layer's b_adj
    in order C1, C2_1, C2_2, C3_1, C3_2, C4 as btype (= float under the
    active INT8x4 config, mat.cuh:65), little-endian float32 here."""
    assert len(b_adj) == 6, "expected 6 layers of b_adj"
    with open(path, "ab") as fp:
        for b in b_adj:
            fp.write(np.asarray(b, dtype="<f4").tobytes())


def read_b_adj(path: str) -> List[List[np.ndarray]]:
    """Read back a save_b_adj telemetry file: list of per-call records,
    each the six b_adj vectors (64, 32, 16, 16, 32, 1 channels)."""
    raw = np.fromfile(path, dtype="<f4")
    sizes = [64, 32, 16, 16, 32, 1]
    per_call = sum(sizes)
    assert raw.size % per_call == 0, f"corrupt b_adj file: {raw.size} floats"
    records = []
    for off in range(0, raw.size, per_call):
        rec, pos = [], off
        for s in sizes:
            rec.append(raw[pos : pos + s].copy())
            pos += s
        records.append(rec)
    return records


def calibrate_dynamic(
    p: DynamicParams, frames: np.ndarray
) -> Tuple[List[int], List[dict]]:
    """Run the dynamic integer path per frame, collecting max_u telemetry —
    the `save_steps` flow that fed the offline mul_shift solve. Returns
    (per-layer running maxima, per-frame telemetry dicts)."""
    telemetry = []
    maxima = [0, 0, 0]
    for i in range(frames.shape[0]):
        _, tel = forward_calibrate(frames[i : i + 1], p)
        telemetry.append(tel)
        for j, m in enumerate(tel["max_u"]):
            flat = max(m) if isinstance(m, tuple) else m
            maxima[j] = max(maxima[j], flat)
    return maxima, telemetry
