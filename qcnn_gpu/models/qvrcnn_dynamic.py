"""Dynamic-quantization (calibration) forward as a jitted XLA program.

Device twin of the oracle's `forward_calibrate` (models/oracle.py), which
mirrors the reference's historical pure-dynamic path: per-layer abs-max
reduction -> runtime step_y -> round-half-away requantization, sorted-step
bias adjustment, and the dynamic concat scale negotiation
(cnn.cu:169-188, 285-320; qvrcnn.cu:82-167, 305-349, 368-385).

This is how the static tables were calibrated: run dynamic, record max_u
telemetry, solve (mul, shift) offline (SURVEY.md §3.3). Here the whole
thing is one compiled program per geometry — the abs-max reductions that
were two-stage shared-memory tree kernels (mat.cu:28-96) are single XLA
reduces.

The bias walk and the final output rescale run in int64 (the reference
uses long long there, qvrcnn.cu:338,374 — the stepy-product can overflow
int32); the program is traced under a local jax.enable_x64 scope since
this environment keeps x64 off globally. Calibration is not a hot path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from qcnn_gpu.models.oracle import DynamicParams, EngineParams

THRESHOLD = 127


def _conv(x_i32, w_i8, b_i32):
    u = lax.conv_general_dilated(
        x_i32.astype(jnp.int8),
        w_i8,
        (1, 1),
        "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    return u + b_i32


def _round_half_away_div(x, d):
    half = d // 2
    pos = (x + half) // d
    neg = -((-x + half) // d)
    return jnp.where(x >= 0, pos, neg)


def _quant_div_clamp(u, step):
    return jnp.clip(_round_half_away_div(u, step), -128, 127)


def _step_from_max(max_u):
    return max_u // (THRESHOLD + 1) + 1


def _concat_dynamic_steps(sw1, max1, sw2, max2):
    sy1 = jnp.where(max1 > THRESHOLD, _step_from_max(max1), 1)
    sy2 = jnp.where(max2 > THRESHOLD, _step_from_max(max2), 1)
    cond = sw1 * sy2 > sw2 * sy1
    sy1_adj = (sw1 * sy2 + (sw2 >> 1)) // sw2
    sy2_adj = (sw2 * sy1 + (sw1 >> 1)) // sw1
    return jnp.where(cond, sy1_adj, sy1), jnp.where(cond, sy2, sy2_adj)


def _adjust_basic(b, stepw_sorted, stepy_sorted, n):
    """b_adj: multiply by the n largest stepw (descending), then
    round-half-away divide by the n smallest stepy (ascending)."""
    t = b
    for i in range(n):
        t = t * stepw_sorted[i]
    for i in range(n):
        t = _round_half_away_div(t, stepy_sorted[i])
    return t


def make_dynamic_forward(p: DynamicParams):
    """fn(uint8 [N,H,W]) -> (rec uint8, telemetry dict of scalars).

    Telemetry: max_u per layer group and the negotiated step_y values —
    the calibration inputs of the offline mul/shift solve."""
    weights = [jnp.asarray(x, dtype=jnp.int8) for x in p.weights]
    biases_np = [x for x in p.biases]
    step_w = [int(v) for v in p.step_w]

    def _impl(x_uint8):
        w = weights
        b = [jnp.asarray(x, dtype=jnp.int64) for x in biases_np]
        sw = [jnp.int64(v) for v in step_w]
        x = x_uint8[..., None].astype(jnp.int32) - 128

        # layer 1 (no prior steps)
        u1 = _conv(x, w[0], b[0])
        max1 = jnp.max(jnp.abs(u1)).astype(jnp.int64)
        sy1 = _step_from_max(max1)
        v1 = _quant_div_clamp(u1, sy1)

        # step bookkeeping after layer 1
        sw_sorted1 = jnp.stack([sw[0]])
        sy_sorted1 = jnp.stack([sy1])

        # layer 2 (ReLU before dynamic concat, qvrcnn.cu:115-120)
        b2_1 = _adjust_basic(b[1], sw_sorted1, sy_sorted1, 1)
        b2_2 = _adjust_basic(b[2], sw_sorted1, sy_sorted1, 1)
        u2_1 = jnp.maximum(_conv(v1, w[1], b2_1), 0)
        u2_2 = jnp.maximum(_conv(v1, w[2], b2_2), 0)
        m2_1 = jnp.max(u2_1).astype(jnp.int64)
        m2_2 = jnp.max(u2_2).astype(jnp.int64)
        sy2_1, sy2_2 = _concat_dynamic_steps(sw[1], m2_1, sw[2], m2_2)
        conc1 = jnp.concatenate(
            [_quant_div_clamp(u2_1, sy2_1), _quant_div_clamp(u2_2, sy2_2)], -1
        )

        sw_sorted2 = jnp.sort(jnp.stack([sw[0], sw[1]]))[::-1]
        sy_sorted2 = jnp.sort(jnp.stack([sy1, sy2_1]))

        # layer 3
        b3_1 = _adjust_basic(b[3], sw_sorted2, sy_sorted2, 2)
        b3_2 = _adjust_basic(b[4], sw_sorted2, sy_sorted2, 2)
        u3_1 = jnp.maximum(_conv(conc1, w[3], b3_1), 0)
        u3_2 = jnp.maximum(_conv(conc1, w[4], b3_2), 0)
        m3_1 = jnp.max(u3_1).astype(jnp.int64)
        m3_2 = jnp.max(u3_2).astype(jnp.int64)
        sy3_1, sy3_2 = _concat_dynamic_steps(sw[3], m3_1, sw[4], m3_2)
        conc2 = jnp.concatenate(
            [_quant_div_clamp(u3_1, sy3_1), _quant_div_clamp(u3_2, sy3_2)], -1
        )

        sw_sorted3 = jnp.sort(jnp.stack([sw[0], sw[1], sw[3]]))[::-1]
        sy_sorted3 = jnp.sort(jnp.stack([sy1, sy2_1, sy3_1]))

        # layer 4 + dynamic output rescale (adjustOutput, qvrcnn.cu:368-385)
        b4 = _adjust_basic(b[5], sw_sorted3, sy_sorted3, 3)
        u4 = _conv(conc2, w[5], b4)
        sw_sorted4 = jnp.sort(jnp.stack([sw[0], sw[1], sw[3], sw[5]]))[::-1]
        sy_sorted4 = jnp.sort(jnp.stack([sy1, sy2_1, sy3_1]))

        t = u4[..., 0]
        for i in range(3):  # multiply by stepy[0..n-2], n=4
            t = t * sy_sorted4[i]
        for i in range(3, -1, -1):  # divide by stepw[n-1..0]
            t = _round_half_away_div(t, sw_sorted4[i])
        res = t.astype(jnp.int8).astype(jnp.int32)  # int8 wrap (xwtype store)

        rec = jnp.clip(x_uint8.astype(jnp.int32) + res, 0, 255).astype(jnp.uint8)
        telemetry = {
            "max_u": (max1, (m2_1, m2_2), (m3_1, m3_2)),
            "step_y": (sy1, (sy2_1, sy2_2), (sy3_1, sy3_2)),
            # save_b_adj analog (qvrcnn.cu:288-304): the adjusted biases each
            # conv actually added this frame, in reference dump order
            # C1, C2_1, C2_2, C3_1, C3_2, C4. C1's bias is never walked
            # (adjustBasic with layer-1 = 0 is the identity).
            "b_adj": (b[0], b2_1, b2_2, b3_1, b3_2, b4),
        }
        return rec, telemetry

    # trace/compile lazily under a local x64 scope (see module docstring)
    cache = {}

    def run(x_uint8):
        import numpy as _np

        key = tuple(_np.shape(x_uint8))
        if key not in cache:
            with jax.enable_x64(True):
                cache[key] = jax.jit(_impl).lower(x_uint8).compile()
        return cache[key](x_uint8)

    return run


def make_hybrid_forward(p: EngineParams):
    """Device twin of the committed hybrid `forward()` (qvrcnn.cu:82-167):

      * C1 requant is `quantize_out_static` -> the `mul_shift` kernel
        (mat.cu:248-261): PRE-multiply rounding bias, NO BLU clamp, and the
        result is stored straight into an int8 buffer — it WRAPS.
      * Both concats use the static fused BLU requant (concat_blu).
      * The final rescale is `adjustOutput_static` with the hardcoded
        (mul=141, shift=16) (qvrcnn.cu:157), also stored through int8.

    Bit-exact twin of `oracle.forward_dynamic_hybrid` (tested). The requant
    products can exceed int32 without the BLU clamp, so the arithmetic runs
    in int64 under a local x64 scope, like the calibrate path — this is a
    parity/calibration mode, not the hot path.

    Returns fn(uint8 [N,H,W]) -> (rec uint8 [N,H,W], max_u_c1 int64 scalar).
    max_u telemetry is what `save_steps` recorded per frame on this path
    (qvrcnn.cu:163).
    """
    p.validate()
    weights = [jnp.asarray(w, dtype=jnp.int8) for w in p.weights]
    biases_np = list(p.biases)
    mul = [int(v) for v in p.mul]
    shift = [int(v) for v in p.shift]
    blu_q = [int(v) for v in p.blu_q]

    def _blu_requant64(u, i):
        bias = (1 << (shift[i] - 1)) // mul[i]
        mid = ((u + bias) * mul[i]) >> shift[i]
        return jnp.where(u > blu_q[i], THRESHOLD, jnp.where(u < 0, 0, mid))

    def _impl(x_uint8):
        b = [jnp.asarray(x, dtype=jnp.int64) for x in biases_np]
        x = x_uint8[..., None].astype(jnp.int32) - 128

        u1 = _conv(x, weights[0], b[0].astype(jnp.int32)).astype(jnp.int64)
        max_u_c1 = jnp.max(jnp.abs(u1))
        bias0 = (1 << (shift[0] - 1)) // mul[0]
        v1 = (((u1 + bias0) * mul[0]) >> shift[0]).astype(jnp.int8)

        def stage(vin, i1, i2):
            u_a = jnp.maximum(_conv(vin, weights[i1], b[i1].astype(jnp.int32)), 0)
            u_b = jnp.maximum(_conv(vin, weights[i2], b[i2].astype(jnp.int32)), 0)
            return jnp.concatenate(
                [
                    _blu_requant64(u_a.astype(jnp.int64), i1),
                    _blu_requant64(u_b.astype(jnp.int64), i2),
                ],
                -1,
            ).astype(jnp.int8)

        conc1 = stage(v1.astype(jnp.int32), 1, 2)
        conc2 = stage(conc1.astype(jnp.int32), 3, 4)
        u4 = _conv(conc2.astype(jnp.int32), weights[5], b[5].astype(jnp.int32))
        u4 = u4[..., 0].astype(jnp.int64)
        res = ((u4 * 141 + (1 << 15)) >> 16).astype(jnp.int8).astype(jnp.int32)
        rec = jnp.clip(x_uint8.astype(jnp.int32) + res, 0, 255).astype(jnp.uint8)
        return rec, max_u_c1

    cache = {}

    def run(x_uint8):
        import numpy as _np

        key = tuple(_np.shape(x_uint8))
        if key not in cache:
            with jax.enable_x64(True):
                cache[key] = jax.jit(_impl).lower(x_uint8).compile()
        return cache[key](x_uint8)

    return run
