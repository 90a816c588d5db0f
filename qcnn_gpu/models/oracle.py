"""Pure-NumPy bit-exact integer oracle for the QVRCNN INT8 engine.

This module is the correctness anchor of the framework: it implements the
reference engine's exact integer semantics (SURVEY.md §5.1) in plain int64
NumPy, with no JAX dependency. Every accelerated path (the XLA graph in
both conv forms, the sharded engine) is tested bit-for-bit against it.

Semantics contract (each item cites the reference behavior it mirrors):

 1. preprocess: x_int = (int)x_uint8 - 128            (cnn.cu:449)
 2. conv: int8 x int8 -> int32 accumulate, cross-correlation, stride 1,
    SAME zero padding of (k-1)/2                      (cnn.cu:44-49)
 3. bias added in the accumulator domain              (cnn.cu:139,155)
 4. fused BLU + requant:
        u >  blu_q -> 127
        u <  0     -> 0
        else       -> ((u + (1<<(shift-1))//mul) * mul) >> shift
    rounding bias is PRE-multiply and integer-divided by mul; >> on a
    non-negative value is floor                        (mat.cu:262-303)
 5. final residual requant: res = (u*mul + (1<<(shift-1))) >> shift with
    the bias POST-multiply and arithmetic shift (floor) on negatives;
    then rec = clamp(x_uint8 + res, 0, 255)           (cnn.cu:507-523)
 6. dynamic-path rounding divide: (x +/- divisor/2) / divisor with C
    truncating division (round half away from zero), clamp [-128,127]
                                                      (mat.cu:197-236)
 7. adjustBasic bias walk: multiply by stepw values (sorted descending),
    then round-half-away divide by stepy values (sorted ascending), in
    64-bit                                            (qvrcnn.cu:305-349)
 8. the dynamic forward uses hardcoded (mul=141, shift=16) for the final
    requant                                           (qvrcnn.cu:157)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from qcnn_gpu.models.topology import QVRCNN_LAYERS

THRESHOLD = 127  # int8 saturation point (mat.cuh:57)


# ---------------------------------------------------------------------------
# Engine parameter container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineParams:
    """Integer parameters of the static (production) engine.

    weights: 6 int8 arrays in HWIO order [k, k, in_ch, out_ch]
    biases:  6 int32 arrays [out_ch] (accumulator domain)
    blu_q:   6 ints — BLU bound in the accumulator domain (0 for C4)
    mul/shift: 6 ints — per-layer requant scale
    """

    weights: List[np.ndarray]
    biases: List[np.ndarray]
    blu_q: List[int]
    mul: List[int]
    shift: List[int]

    def validate(self) -> None:
        for i, (layer, w, b) in enumerate(zip(QVRCNN_LAYERS, self.weights, self.biases)):
            k, _, cin, cout = w.shape
            assert w.dtype == np.int8, f"layer {i} weights must be int8"
            assert (k, cin, cout) == (layer.ksize, layer.in_ch, layer.out_ch), (
                f"layer {layer.name}: got {w.shape}"
            )
            assert b.shape == (layer.out_ch,)

    @classmethod
    def from_float(cls, weights_f, biases_f, table, wbits: int = 8) -> "EngineParams":
        """Quantize float HWIO weights/biases onto the signed `wbits` grid
        using a QuantTable: w_int = clip(round(w/stepw), -2^(b-1), 2^(b-1)-1)
        and b_int = round(b * ratio_in / stepw) — the integer bias the
        engine adds in the accumulator domain (the domain where x carries
        scale ratio_in and w carries 1/stepw; cf. conv_validation printing
        round(b/stepw*ratio), model.py:381).

        wbits=8 is the reference grid; wbits=4 is the INT4 stretch variant
        (BASELINE config 5): int4-valued weights stored in int8, running
        through the identical integer arithmetic — the solver's stepw must
        come from stepw_from_weights(bits=4) for full-range use."""
        lo, hi = -(1 << (wbits - 1)), (1 << (wbits - 1)) - 1
        ws, bs, blus, muls, shifts = [], [], [], [], []

        def field(v):
            """Scalar rows stay Python ints; per-channel rows
            (LayerQuantVec) stay [out_ch] int64 vectors — every integer
            primitive below broadcasts them over the channel axis."""
            return np.asarray(v, np.int64) if np.ndim(v) else int(v)

        for wf, bf, row in zip(weights_f, biases_f, table):
            wq = np.clip(np.round(wf / row.stepw), lo, hi).astype(np.int8)
            bq = np.round(np.asarray(bf) * row.ratio / row.stepw).astype(np.int32)
            ws.append(wq)
            bs.append(bq)
            blus.append(field(row.blu_q))
            muls.append(field(row.mul))
            shifts.append(field(row.shift))
        return cls(ws, bs, blus, muls, shifts)


@dataclasses.dataclass
class DynamicParams:
    """Parameters of the dynamic-quantization (calibration) engine:
    per-layer integer stepw plus int8 weights / int32 biases."""

    step_w: List[int]
    weights: List[np.ndarray]
    biases: List[np.ndarray]


# ---------------------------------------------------------------------------
# Integer primitives
# ---------------------------------------------------------------------------


def preprocess(x_uint8: np.ndarray) -> np.ndarray:
    """uint8 frame -> symmetric int [-128, 127]."""
    return x_uint8.astype(np.int64) - 128


def conv_int(x: np.ndarray, w: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """Integer cross-correlation, SAME zero pad, stride 1.

    x: [N, H, W, Cin] int, w: [k, k, Cin, Cout] int, b: [Cout] int.
    Accumulates in int64 (the engine's int32 accumulator never overflows in
    practice; the oracle uses 64-bit so it can never be the thing that's
    wrong). Returns [N, H, W, Cout] int64.
    """
    # Accumulate through float64 BLAS matmuls: every partial product is an
    # integer <= 128*128 = 16384 and the largest possible accumulation
    # (1600 terms for C2_2) stays below 2^25 — float64 is exact up to 2^53,
    # so this is bit-identical to int64 accumulation and ~100x faster.
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    k = w.shape[0]
    pad = (k - 1) // 2
    n, h, wd, cin = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.zeros((n, h, wd, w.shape[3]), dtype=np.float64)
    for dy in range(k):
        for dx in range(k):
            # patch [N,H,W,Cin] . w[dy,dx] [Cin,Cout]
            out += xp[:, dy : dy + h, dx : dx + wd, :] @ w[dy, dx]
    out = out.astype(np.int64)
    if b is not None:
        out += b.astype(np.int64)
    return out


def blu_requant(u: np.ndarray, blu_q, mul, shift) -> np.ndarray:
    """Fused BLU + requantization (contract item 4). Returns int64 in [0,127].

    blu_q/mul/shift are per-layer scalars, or [out_ch] vectors broadcast
    over u's channel axis (per-channel tables, LayerQuantVec)."""
    u = u.astype(np.int64)
    blu_q = np.asarray(blu_q, np.int64)
    mul = np.asarray(mul, np.int64)
    shift = np.asarray(shift, np.int64)
    bias = (1 << (shift - 1)) // mul
    mid = ((u + bias) * mul) >> shift  # u >= 0 here => floor shift
    return np.where(u > blu_q, THRESHOLD, np.where(u < 0, 0, mid))


def final_residual_requant(u: np.ndarray, mul: int, shift: int) -> np.ndarray:
    """Residual requant with POST-multiply bias (contract item 5)."""
    u = u.astype(np.int64)
    return (u * mul + (1 << (shift - 1))) >> shift  # arithmetic shift: floor


def apply_residual(x_uint8: np.ndarray, res: np.ndarray) -> np.ndarray:
    """rec = clamp(x + res, 0, 255) in integer domain (cnn.cu:517-520)."""
    return np.clip(x_uint8.astype(np.int64) + res, 0, 255).astype(np.uint8)


def round_half_away_div(x: np.ndarray, d: int) -> np.ndarray:
    """C-style (x +/- d/2) / d with truncating division (contract item 6)."""
    x = x.astype(np.int64)
    half = d >> 1
    pos = (x + half) // d
    neg = -((-x + half) // d)  # trunc-toward-zero of (x - half)/d for x<0
    return np.where(x >= 0, pos, neg)


def quant_div_clamp(u: np.ndarray, step: int) -> np.ndarray:
    """Dynamic-path requant: round-half-away divide then clamp [-128,127]."""
    return np.clip(round_half_away_div(u, step), -128, 127)


def wrap_int8(x: np.ndarray) -> np.ndarray:
    """Truncate an integer to 8 bits (C char assignment wraps; used where
    the reference stores unclamped requant results into int8 buffers,
    mat.cu:248-261, qvrcnn.cu:386-397)."""
    return x.astype(np.int64).astype(np.int8).astype(np.int64)


# ---------------------------------------------------------------------------
# Static fused forward (production path — forward_blu, qvrcnn.cu:168-242)
# ---------------------------------------------------------------------------


def forward_blu(
    x_uint8: np.ndarray, p: EngineParams, collect_intermediates: bool = False
):
    """The production int8 pipeline. x_uint8: [N, H, W] or [N, H, W, 1].

    Returns rec_uint8 [N, H, W] (and a dict of intermediates if asked).
    """
    squeeze = x_uint8.ndim == 3
    if squeeze:
        x_uint8 = x_uint8[..., None]

    x = preprocess(x_uint8)
    inter = {}

    u1 = conv_int(x, p.weights[0], p.biases[0])
    v1 = blu_requant(u1, p.blu_q[0], p.mul[0], p.shift[0])

    u2_1 = conv_int(v1, p.weights[1], p.biases[1])
    u2_2 = conv_int(v1, p.weights[2], p.biases[2])
    conc1 = np.concatenate(
        [
            blu_requant(u2_1, p.blu_q[1], p.mul[1], p.shift[1]),
            blu_requant(u2_2, p.blu_q[2], p.mul[2], p.shift[2]),
        ],
        axis=-1,
    )

    u3_1 = conv_int(conc1, p.weights[3], p.biases[3])
    u3_2 = conv_int(conc1, p.weights[4], p.biases[4])
    conc2 = np.concatenate(
        [
            blu_requant(u3_1, p.blu_q[3], p.mul[3], p.shift[3]),
            blu_requant(u3_2, p.blu_q[4], p.mul[4], p.shift[4]),
        ],
        axis=-1,
    )

    u4 = conv_int(conc2, p.weights[5], p.biases[5])
    res = final_residual_requant(u4, p.mul[5], p.shift[5])
    rec = apply_residual(x_uint8, res)

    if collect_intermediates:
        inter = {
            "x_ppro": x,
            "u1": u1,
            "v1": v1,
            "u2_1": u2_1,
            "u2_2": u2_2,
            "conc1": conc1,
            "u3_1": u3_1,
            "u3_2": u3_2,
            "conc2": conc2,
            "u4": u4,
            "res": res,
        }
    rec = rec[..., 0] if squeeze else rec
    return (rec, inter) if collect_intermediates else rec


# ---------------------------------------------------------------------------
# Dynamic / calibration paths
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepState:
    """Sorted step bookkeeping: stepw descending, stepy ascending — mirrors
    insert_w/insert_y insertion sorts (qvrcnn.cu:305-330)."""

    stepw: List[int] = dataclasses.field(default_factory=list)
    stepy: List[int] = dataclasses.field(default_factory=list)

    def insert_w(self, v: int) -> None:
        self.stepw.append(v)
        self.stepw.sort(reverse=True)

    def insert_y(self, v: int) -> None:
        self.stepy.append(v)
        self.stepy.sort()


def adjust_basic(b: np.ndarray, steps: StepState, n: int) -> np.ndarray:
    """b_adj = b * prod(stepw[:n]) then sequential round-half-away division
    by stepy[:n] (contract item 7, qvrcnn.cu:336-349)."""
    t = b.astype(np.int64)
    for i in range(n):
        t = t * steps.stepw[i]
    for i in range(n):
        t = round_half_away_div(t, steps.stepy[i])
    return t


def adjust_output(u: np.ndarray, steps: StepState, n: int) -> np.ndarray:
    """Dynamic final rescale: multiply by stepy[:n-1], then round-half-away
    divide by stepw[n-1..0] (qvrcnn.cu:368-385); stored into int8 (wraps)."""
    t = u.astype(np.int64)
    for i in range(n - 1):
        t = t * steps.stepy[i]
    for i in range(n - 1, -1, -1):
        t = round_half_away_div(t, steps.stepw[i])
    return wrap_int8(t)


def find_max_abs(u: np.ndarray) -> int:
    """max(|u|) over a tensor (mat.cu:28-96)."""
    return int(np.max(np.abs(u)))


def step_from_max(max_u: int) -> int:
    """step_y = max/(THRESHOLD+1) + 1 (cnn.cu:176,185)."""
    return max_u // (THRESHOLD + 1) + 1


def concat_dynamic_steps(step_w1: int, max1: int, step_w2: int, max2: int):
    """Dynamic concat scale negotiation (cnn.cu:285-343): per-branch step
    from max, then the smaller-gain branch's step is re-derived so both
    branches land on a common output scale."""
    stepy1 = step_from_max(max1) if max1 > THRESHOLD else 1
    stepy2 = step_from_max(max2) if max2 > THRESHOLD else 1
    if step_w1 * stepy2 > step_w2 * stepy1:
        stepy1 = (step_w1 * stepy2 + (step_w2 >> 1)) // step_w2
    else:
        stepy2 = (step_w2 * stepy1 + (step_w1 >> 1)) // step_w1
    return stepy1, stepy2


def forward_calibrate(x_uint8: np.ndarray, p: DynamicParams):
    """The historical pure-dynamic path: per-layer abs-max -> step_y ->
    round-half-away requant; used to calibrate the static tables
    (quantize_out cnn.cu:169-178, concat cnn.cu:285-320, adjustOutput).

    Returns (rec_uint8, telemetry) where telemetry carries per-layer max_u
    and the chosen steps — the inputs of the offline mul/shift solve.
    """
    squeeze = x_uint8.ndim == 3
    if squeeze:
        x_uint8 = x_uint8[..., None]
    x = preprocess(x_uint8)
    steps = StepState()
    telemetry = {"max_u": [], "step_y": [], "b_adj": [None] * 6}

    def layer(idx, xin, n_prior):
        b_adj = adjust_basic(p.biases[idx], steps, n_prior)
        telemetry["b_adj"][idx] = b_adj  # save_b_adj analog (qvrcnn.cu:288-304)
        return conv_int(xin, p.weights[idx], b_adj)

    # layer 1
    u1 = layer(0, x, 0)
    max1 = find_max_abs(u1)
    sy1 = step_from_max(max1)
    v1 = quant_div_clamp(u1, sy1)
    steps.insert_w(p.step_w[0])
    steps.insert_y(sy1)
    telemetry["max_u"].append(max1)
    telemetry["step_y"].append(sy1)

    # layer 2 (concat): ReLU applied before dynamic concat (qvrcnn.cu:115-120)
    u2_1 = np.maximum(layer(1, v1, 1), 0)
    u2_2 = np.maximum(layer(2, v1, 1), 0)
    m1, m2 = find_max_abs(u2_1), find_max_abs(u2_2)
    sy2_1, sy2_2 = concat_dynamic_steps(p.step_w[1], m1, p.step_w[2], m2)
    conc1 = np.concatenate(
        [quant_div_clamp(u2_1, sy2_1), quant_div_clamp(u2_2, sy2_2)], axis=-1
    )
    steps.insert_w(p.step_w[1])
    steps.insert_y(sy2_1)
    telemetry["max_u"].append((m1, m2))
    telemetry["step_y"].append((sy2_1, sy2_2))

    # layer 3 (concat)
    u3_1 = np.maximum(layer(3, conc1, 2), 0)
    u3_2 = np.maximum(layer(4, conc1, 2), 0)
    m1, m2 = find_max_abs(u3_1), find_max_abs(u3_2)
    sy3_1, sy3_2 = concat_dynamic_steps(p.step_w[3], m1, p.step_w[4], m2)
    conc2 = np.concatenate(
        [quant_div_clamp(u3_1, sy3_1), quant_div_clamp(u3_2, sy3_2)], axis=-1
    )
    steps.insert_w(p.step_w[3])
    steps.insert_y(sy3_1)
    telemetry["max_u"].append((m1, m2))
    telemetry["step_y"].append((sy3_1, sy3_2))

    # layer 4 + dynamic output rescale
    u4 = layer(5, conc2, 3)
    steps.insert_w(p.step_w[5])
    res = adjust_output(u4, steps, 4)
    rec = apply_residual(x_uint8, res)
    telemetry["steps"] = steps
    rec = rec[..., 0] if squeeze else rec
    return rec, telemetry


def forward_dynamic_hybrid(x_uint8: np.ndarray, sp: EngineParams):
    """The reference's current `forward()` as committed (qvrcnn.cu:82-167):
    static mul/shift requant for C1 (no BLU clamp, int8 wrap), static BLU
    concats, and the hardcoded (141, 16) final rescale. Kept for parity —
    this is the mode that produced the reference's max_u calibration data.
    """
    squeeze = x_uint8.ndim == 3
    if squeeze:
        x_uint8 = x_uint8[..., None]
    x = preprocess(x_uint8)

    u1 = conv_int(x, sp.weights[0], sp.biases[0])
    bias = (1 << (sp.shift[0] - 1)) // sp.mul[0]
    v1 = wrap_int8(((u1 + bias) * sp.mul[0]) >> sp.shift[0])  # mat.cu:248-261

    u2_1 = np.maximum(conv_int(v1, sp.weights[1], sp.biases[1]), 0)
    u2_2 = np.maximum(conv_int(v1, sp.weights[2], sp.biases[2]), 0)
    conc1 = np.concatenate(
        [
            blu_requant(u2_1, sp.blu_q[1], sp.mul[1], sp.shift[1]),
            blu_requant(u2_2, sp.blu_q[2], sp.mul[2], sp.shift[2]),
        ],
        axis=-1,
    )
    u3_1 = np.maximum(conv_int(conc1, sp.weights[3], sp.biases[3]), 0)
    u3_2 = np.maximum(conv_int(conc1, sp.weights[4], sp.biases[4]), 0)
    conc2 = np.concatenate(
        [
            blu_requant(u3_1, sp.blu_q[3], sp.mul[3], sp.shift[3]),
            blu_requant(u3_2, sp.blu_q[4], sp.mul[4], sp.shift[4]),
        ],
        axis=-1,
    )
    u4 = conv_int(conc2, sp.weights[5], sp.biases[5])
    # adjustOutput_static with hardcoded mul=141, shift=16 (qvrcnn.cu:157)
    res = wrap_int8((u4 * 141 + (1 << 15)) >> 16)
    rec = apply_residual(x_uint8, res)
    return rec[..., 0] if squeeze else rec
