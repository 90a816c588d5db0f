"""EDSR-scale wide restoration CNN — the channel-sharded stretch model.

BASELINE config 5 / SURVEY.md §2.4 P6: QVRCNN's 64 channels fit one chip
trivially, so tensor parallelism there is pure demonstration. This model
family is the configuration TP exists for — a deep, WIDE (≥256-channel)
restoration net whose per-layer weights and arithmetic exceed one chip's
sweet spot and shard naturally over channels.

Topology (configurable): head 3x3 conv 1->C, `blocks` 3x3 convs C->C, tail
3x3 conv C->1; every hidden layer uses the BLU+requant epilogue of the
QVRCNN engine (SURVEY §5.1 item 4, mat.cu:262-314 semantics) and the tail
uses the final-residual requant (item 5, cnn.cu:507-523); output is a
residual added to the input frame, clamped to [0, 255]. All arithmetic is
int8 x int8 -> int32 with the identical fixed-point contract, so the whole
existing numeric stack is reused unchanged: `quant.solver` chains the
(mul, shift) tables exactly as for QVRCNN (quantization.py:25-64 analog,
minus concat equalization — the chain is linear), `ops.requant` provides
the device epilogues, and `models.oracle`'s integer primitives are the
bit-exactness spec.

Quantization scale note: blu_q for a 256-channel layer can reach ~2^21
(fan-in 9*256 at ratio ~16k); accumulators stay far below 2^25 so the
int32 device path and the float64-BLAS oracle both hold exactly, same
argument as oracle.conv_int's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from qcnn_gpu.models import oracle as O
from qcnn_gpu.quant.params import LayerQuant
from qcnn_gpu.quant.solver import solve_last, solve_layer, stepw_from_weights


@dataclasses.dataclass
class WideParams:
    """INT8 wide-net parameters: per-layer int8 weights [3,3,cin,cout],
    int32 biases, and the fixed-point requant table. Layers in order:
    head, blocks x body, tail. blu_q/mul/shift rows cover head + body;
    (mul_last, shift_last) is the tail's residual requant."""

    weights: List[np.ndarray]
    biases: List[np.ndarray]
    blu_q: List[int]
    mul: List[int]
    shift: List[int]
    mul_last: int
    shift_last: int

    @property
    def channels(self) -> int:
        return self.weights[0].shape[3]

    @property
    def blocks(self) -> int:
        return len(self.weights) - 2

    # ---- persistence (npz; no reference format exists for this family) --
    def save(self, path: str) -> None:
        arrs = {"mul_last": self.mul_last, "shift_last": self.shift_last}
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            arrs[f"w{i}"] = w
            arrs[f"b{i}"] = b
        arrs["blu_q"] = np.asarray(self.blu_q, np.int64)
        arrs["mul"] = np.asarray(self.mul, np.int64)
        arrs["shift"] = np.asarray(self.shift, np.int64)
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "WideParams":
        z = np.load(path)
        n = sum(1 for k in z.files if k.startswith("w"))
        return cls(
            weights=[z[f"w{i}"] for i in range(n)],
            biases=[z[f"b{i}"] for i in range(n)],
            blu_q=[int(v) for v in z["blu_q"]],
            mul=[int(v) for v in z["mul"]],
            shift=[int(v) for v in z["shift"]],
            mul_last=int(z["mul_last"]),
            shift_last=int(z["shift_last"]),
        )


def _solve_layer_capped(ratio: float, stepw: float, blu: float,
                        cap: int = 24) -> LayerQuant:
    """solve_layer with the shift capped for int32 device headroom.

    The reference's window search (quantization.py:5-14) falls back to
    shift=27 when no candidate lands in (127, 127.5] — harmless for its
    float-accumulator build, but (u + bias)*mul then reaches ~127.5*2^27
    and wraps int32 on the int8 engine path. Since solve_layer RECENTERS the BLU
    bound from the chosen (mul, shift) (int 127 == the clip by
    construction), any sufficiently precise pair is self-consistent: cap
    the shift at 24 (product <= ~127.5*2^24 < 2^31) and re-derive. blu_q
    is then nudged down until the requant of blu_q itself is <= 127, so
    the int8 range contract holds exactly."""
    row = solve_layer(ratio, stepw, blu)
    if row.shift > cap:
        blu_q0 = round(blu * ratio / stepw)
        mul = max(1, round(127.5 * 2.0**cap / blu_q0))
        blu_adj = 127.0 * 2.0**cap / mul * stepw / ratio
        blu_q = round(blu_adj * ratio / stepw)
        row = LayerQuant(stepw, ratio, blu_adj, blu_q, mul, cap)
    # exact int8 contract: requant(blu_q) must not exceed 127
    bias = (1 << (row.shift - 1)) // row.mul
    for _ in range(4):
        if ((row.blu_q + bias) * row.mul) >> row.shift <= 127:
            break
        row = LayerQuant(row.stepw, row.ratio, row.blu_adj,
                         row.blu_q - 1, row.mul, row.shift)
    if (row.blu_q + bias) * row.mul >= 2**31:
        raise ValueError(
            f"blu_q={row.blu_q} x mul={row.mul} overflows int32 even at "
            f"shift={row.shift} — rescale the float weights/BLU"
        )
    return row


def solve_wide_table(
    stepw: Sequence[float], blu: Sequence[float]
) -> List[LayerQuant]:
    """Chain the fixed-point solve through the linear wide graph: head +
    body layers via the shift-capped solve_layer (BLU window), tail via
    solve_last against final pixel scale 255 — the straight-line analog
    of solver.solve_network (quantization.py:55-64 without concat rows)."""
    rows = []
    ratio = 255.0
    for sw, bl in zip(stepw[:-1], blu[:-1]):
        row = _solve_layer_capped(ratio, sw, bl)
        rows.append(row)
        ratio = ratio / row.stepw * row.mul / 2.0**row.shift
    rows.append(solve_last(ratio, stepw[-1]))
    return rows


def quantize_wide(
    ws_float: Sequence[np.ndarray],
    bs_float: Sequence[np.ndarray],
    blu: Sequence[float],
    wbits: int = 8,
) -> WideParams:
    """Float weights + BLU bounds -> INT8 WideParams via the real solver.

    Same recipe as engine/calibrate.quantize_model: w_int = round(w/stepw)
    on the signed grid; b_int = round(b * ratio_in / stepw) so the bias
    lands in the accumulator domain (model.py:199-202 / cnn.cu:139 analog).
    """
    stepw = stepw_from_weights(list(ws_float), bits=wbits)
    rows = solve_wide_table(stepw, list(blu))
    lim = (1 << (wbits - 1)) - 1
    ws, bs = [], []
    for w, b, row in zip(ws_float, bs_float, rows):
        ws.append(
            np.clip(np.round(np.asarray(w) / row.stepw), -lim - 1, lim).astype(np.int8)
        )
        bs.append(
            np.round(np.asarray(b) * row.ratio / row.stepw).astype(np.int32)
        )
    # tail int32 headroom: final_residual_i32 computes u*mul in int32;
    # bound u by the worst-case accumulator of the quantized tail weights
    u_max = int(
        np.abs(ws[-1].astype(np.int64)).sum() * 127
        + np.abs(bs[-1].astype(np.int64)).max()
    )
    if u_max * rows[-1].mul >= 2**30:
        raise ValueError(
            f"tail mul={rows[-1].mul} x max accumulator {u_max} overflows"
            " the int32 residual requant — rescale the float weights"
        )
    return WideParams(
        weights=ws,
        biases=bs,
        blu_q=[r.blu_q for r in rows[:-1]],
        mul=[r.mul for r in rows[:-1]],
        shift=[r.shift for r in rows[:-1]],
        mul_last=rows[-1].mul,
        shift_last=rows[-1].shift,
    )


def synth_wide_params(
    channels: int = 256, blocks: int = 10, seed: int = 0, wbits: int = 8
) -> WideParams:
    """Realistically-scaled synthetic WideParams (testing/bench fixture,
    same role as testing.synth_engine_params)."""
    rng = np.random.default_rng(seed)
    shapes = (
        [(3, 3, 1, channels)]
        + [(3, 3, channels, channels)] * blocks
        + [(3, 3, channels, 1)]
    )
    ws, bs = [], []
    for shp in shapes:
        fan_in = shp[0] * shp[1] * shp[2]
        ws.append(rng.normal(0, 0.6 / np.sqrt(fan_in), shp).astype(np.float32))
        bs.append(rng.normal(0, 0.01, shp[3]).astype(np.float32))
    blu = [2.0] * (len(shapes) - 1) + [0.0]
    return quantize_wide(ws, bs, blu, wbits=wbits)


def float_forward(ws, bs, x_norm, blu: float = 2.0):
    """Float twin for training, in the reference's normalized pixel domain
    (x_norm = (x_uint8 - 128)/255, model.py:32-33 contract; ratio = 255
    maps it onto the integer engine's input scale exactly). Hidden layers
    clip to [0, blu] (BLU); the tail returns the raw float residual."""
    import jax.numpy as jnp
    from jax import lax

    dn = ("NHWC", "HWIO", "NHWC")
    v = x_norm
    for i in range(len(ws) - 1):
        u = lax.conv_general_dilated(v, ws[i], (1, 1), "SAME", dimension_numbers=dn)
        v = jnp.clip(u + bs[i], 0.0, blu)
    u = lax.conv_general_dilated(v, ws[-1], (1, 1), "SAME", dimension_numbers=dn)
    return u + bs[-1]


# ---------------------------------------------------------------------------
# NumPy oracle (the executable spec; same primitives as oracle.forward_blu)
# ---------------------------------------------------------------------------


def forward_wide(x_uint8: np.ndarray, p: WideParams) -> np.ndarray:
    """Bit-exact integer reference: uint8 [N,H,W] -> restored uint8."""
    squeeze = x_uint8.ndim == 3
    x4 = x_uint8[..., None] if squeeze else x_uint8
    v = O.preprocess(x4)
    for i in range(len(p.weights) - 1):
        u = O.conv_int(v, p.weights[i], p.biases[i])
        v = O.blu_requant(u, p.blu_q[i], p.mul[i], p.shift[i])
    u = O.conv_int(v, p.weights[-1], p.biases[-1])
    res = O.final_residual_requant(u, p.mul_last, p.shift_last)
    rec = O.apply_residual(x4, res)
    return rec[..., 0] if squeeze else rec


# ---------------------------------------------------------------------------
# XLA forward (single chip / data parallel)
# ---------------------------------------------------------------------------


def make_wide_forward(p: WideParams):
    """Jitted fn(uint8 [N,H,W]) -> uint8 [N,H,W], bit-exact vs
    forward_wide. Plain int8 XLA convs with int32 accumulation — at 256+
    channels (K=2304 per body conv) the convs are large enough for the
    library conv, so no hand-written kernel is involved."""
    import jax
    import jax.numpy as jnp

    from qcnn_gpu.models.qvrcnn import _conv_int
    from qcnn_gpu.ops.requant import (
        apply_residual_u8,
        blu_requant_i32,
        final_residual_i32,
    )

    ws = [jnp.asarray(w) for w in p.weights]
    bs = [jnp.asarray(b, jnp.int32) for b in p.biases]

    @jax.jit
    def run(x_uint8):
        v = x_uint8[..., None].astype(jnp.int32) - 128
        for i in range(len(ws) - 1):
            u = _conv_int(v, ws[i], bs[i])
            v = blu_requant_i32(u, p.blu_q[i], p.mul[i], p.shift[i])
        u = _conv_int(v, ws[-1], bs[-1])
        res = final_residual_i32(u, p.mul_last, p.shift_last)[..., 0]
        return apply_residual_u8(x_uint8, res)

    run.impl = "wide-int"
    return run


# ---------------------------------------------------------------------------
# FP8 requant variant (BASELINE config 5 stretch: "INT4/FP8")
# ---------------------------------------------------------------------------


def quantize_wide_fp8(ws: Sequence[np.ndarray], bs: Sequence[np.ndarray]):
    """Per-output-channel absmax scaling of float weights onto
    float8_e4m3 (dynamic range ±448): returns (w8 list, scale list
    float32 [cout]). The quantization error this introduces is the FP8
    variant's entire deviation from the float model — biases stay fp32."""
    import jax.numpy as jnp

    w8, scales = [], []
    for w in ws:
        amax = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12)
        s = (amax / 448.0).astype(np.float32)
        w8.append(jnp.asarray(w / s, dtype=jnp.float8_e4m3fn))
        scales.append(jnp.asarray(s))
    return w8, scales


def make_wide_forward_fp8(ws, bs, blu: float = 2.0):
    """FP8 twin of make_wide_forward: fn(uint8 [N,H,W]) -> uint8 [N,H,W].

    Weights are stored float8_e4m3 per-channel scaled (half the HBM and
    wire bytes of bf16, a quarter of fp32) and the INTER-LAYER activations
    are requantized to float8_e4m3 with the per-layer scale blu/448 — the
    FP8 analog of the INT8 path's blu_requant epilogue (mat.cu:262-314
    semantics: scale, clip to the BLU bound, narrow). The conv math runs
    bf16 with fp32 accumulation, so FP8 here buys memory/bandwidth, not
    FLOPs — documented, not hidden (hardware with native FP8 matmul lowers
    the same program
    to it via preferred_element_type).

    Contract: NOT bit-exact (unlike every INT path in this package —
    float rounding is platform-scheduled); validated by PSNR tolerance
    against the float model (tests/test_wide.py). Reference parity:
    quantization.py:5-64's role (scale solving) collapses to the static
    absmax/448 per-channel scales; there is no integer window search
    because FP8 carries its exponent per value."""
    import jax
    import jax.numpy as jnp

    w8, scales = quantize_wide_fp8(ws, bs)
    bsj = [jnp.asarray(b, jnp.float32) for b in bs]
    sa = np.float32(blu / 448.0)  # activation scale, all hidden layers
    dn = ("NHWC", "HWIO", "NHWC")

    @jax.jit
    def run(x_uint8):
        from jax import lax

        v = ((x_uint8[..., None].astype(jnp.float32) - 128.0) / 255.0).astype(
            jnp.bfloat16
        )
        act_s = jnp.bfloat16(1.0)  # input layer sees the raw normalized x
        for i in range(len(w8) - 1):
            u = lax.conv_general_dilated(
                v.astype(jnp.bfloat16),
                w8[i].astype(jnp.bfloat16),
                (1, 1),
                "SAME",
                dimension_numbers=dn,
                preferred_element_type=jnp.float32,
            )
            u = u * (scales[i] * act_s) + bsj[i]
            # FP8 activation requant: scale onto ±448, narrow, carry the
            # scale into the next conv's epilogue (exact algebra; the only
            # loss is the fp8 rounding itself)
            v = jnp.clip(u, 0.0, blu)
            v = (v / sa).astype(jnp.float8_e4m3fn)
            act_s = jnp.bfloat16(sa)
        u = lax.conv_general_dilated(
            v.astype(jnp.bfloat16),
            w8[-1].astype(jnp.bfloat16),
            (1, 1),
            "SAME",
            dimension_numbers=dn,
            preferred_element_type=jnp.float32,
        )
        res = u * (scales[-1] * act_s) + bsj[-1]
        rec = x_uint8.astype(jnp.float32) + jnp.round(res[..., 0] * 255.0)
        return jnp.clip(rec, 0.0, 255.0).astype(jnp.uint8)

    run.impl = "wide-fp8"
    run.weight_bytes = sum(int(np.prod(w.shape)) for w in w8)
    return run
