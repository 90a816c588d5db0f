"""Per-output-channel quantization tables (the INT4 quality closure).

The reference solves ONE stepw per layer (training/quantization.py:77-86);
per-channel rows generalize that with the same math: each channel gets its
own weight grid and (mul, shift), equalized to a common output pixel scale
exactly as the reference equalizes concat branches (quantization.py:42-49).
These tests hold the solver to its invariants and the engines to
bit-exactness against the oracle on per-channel tables.
"""

import io

import numpy as np
import pytest

from qcnn_gpu.models import float_model as FM
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.qvrcnn import make_forward
from qcnn_gpu.quant.params import LayerQuantVec
from qcnn_gpu.quant.solver import (
    BLU_INIT,
    solve_network,
    solve_network_per_channel,
    stepw_from_weights,
    stepw_per_channel,
)
from qcnn_gpu.testing import synth_frames

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def float_lists():
    params = FM.init_params(seed=11)
    ws, bs = FM.params_to_lists(params)
    return [np.asarray(w) for w in ws], [np.asarray(b) for b in bs]


def _table(ws, bits=4, qp=37):
    return solve_network_per_channel(
        stepw_per_channel(ws, bits=bits), BLU_INIT[qp]
    )


def test_solver_common_output_scale(float_lists):
    """Every channel of a row lands on the SAME output pixel scale
    ratio/stepw_c * mul_c / 2^shift_c (the equalization invariant), and
    the scale chains into the next row's stored input ratio."""
    ws, _ = float_lists
    t = _table(ws)
    prev_out = None
    for i in (0, 1, 2, 3, 4):
        r = t[i]
        assert isinstance(r, LayerQuantVec)
        gains = r.ratio / r.stepw * r.mul / np.exp2(r.shift)
        assert np.allclose(gains, gains[0], rtol=1e-12), f"row {i}"
        if prev_out is not None and i in (1, 3):
            assert r.ratio == pytest.approx(prev_out, rel=1e-12)
        if i in (0, 1, 3):  # C1 / concat reps chain the running scale
            prev_out = float(gains[0])
    # concat partners share their branch's common scale
    for a, b in ((t[1], t[2]), (t[3], t[4])):
        ga = a.ratio / a.stepw[0] * a.mul[0] / 2.0 ** float(a.shift[0])
        gb = b.ratio / b.stepw[0] * b.mul[0] / 2.0 ** float(b.shift[0])
        assert ga == pytest.approx(gb, rel=1e-12)


def test_solver_saturation_window(float_lists):
    """Per channel: the ENGINE's requant (pre-multiply rounding bias,
    mat.cu:286-291) maps the clip boundary blu_q to exactly 127 and can
    never exceed it — the invariant that makes the int8 clamp BE the
    activation."""
    ws, _ = float_lists
    t = _table(ws)
    for i in range(5):
        r = t[i]
        bias = (1 << (r.shift - 1)) // r.mul
        got = ((r.blu_q + bias) * r.mul) >> r.shift
        assert (got == 127).all(), f"row {i}: {np.unique(got)}"


def test_solver_only_raises_stepw(float_lists):
    """Equalization may only COARSEN a channel's grid (stepw up), never
    refine it below the abs-max-derived step — quantized weights must
    still fit the 4-bit grid."""
    ws, _ = float_lists
    raw = stepw_per_channel(ws, bits=4)
    t = _table(ws)
    for i in range(5):
        assert (t[i].stepw >= raw[i] * (1 - 1e-12)).all()
    # and per-channel grids are never coarser than the layer-wide grid
    layer = stepw_from_weights(ws, bits=4)
    for i in range(5):
        assert (t[i].stepw <= layer[i] * (1 + 0.01)).all()


def test_engine_bit_exact_on_per_channel_table(float_lists):
    ws, bs = float_lists
    ep = O.EngineParams.from_float(ws, bs, _table(ws), wbits=4)
    for w in ep.weights:
        assert w.min() >= -8 and w.max() <= 7
    x = synth_frames(2, 36, 52, seed=5)
    want = O.forward_blu(x, ep)
    for impl in ("bf16", "int"):
        got = np.asarray(make_forward(ep, impl=impl)(x))
        assert (got == want).all(), impl


def test_pc_format_roundtrip(float_lists):
    from qcnn_gpu.data.model_files import (
        read_static_qfp_auto,
        read_static_qfp_pc,
        write_static_qfp_pc,
    )

    ws, bs = float_lists
    ep = O.EngineParams.from_float(ws, bs, _table(ws), wbits=4)
    buf = io.BytesIO()
    write_static_qfp_pc(buf, ep)
    buf.seek(0)
    p2 = read_static_qfp_pc(buf)
    for i in range(6):
        assert (p2.weights[i] == ep.weights[i]).all()
        assert (p2.biases[i] == ep.biases[i]).all()
        assert np.array_equal(np.asarray(p2.blu_q[i]), np.asarray(ep.blu_q[i]))
        assert np.array_equal(np.asarray(p2.mul[i]), np.asarray(ep.mul[i]))
        assert np.array_equal(np.asarray(p2.shift[i]), np.asarray(ep.shift[i]))
    # C4 (one channel) collapses to a scalar on read -> merged graph's
    # int() coercions keep working
    assert np.ndim(p2.mul[5]) == 0
    x = synth_frames(1, 24, 40, seed=7)
    assert (O.forward_blu(x, p2) == O.forward_blu(x, ep)).all()


def test_pc_format_collapses_scalar_tables(float_lists):
    """A scalar table written through the pc container reads back with
    scalar rows — lossless round trip for reference-style tables."""
    from qcnn_gpu.data.model_files import (
        read_static_qfp_pc,
        write_static_qfp_pc,
    )

    ws, bs = float_lists
    t = solve_network(stepw_from_weights(ws, bits=8), BLU_INIT[27])
    ep = O.EngineParams.from_float(ws, bs, t, wbits=8)
    buf = io.BytesIO()
    write_static_qfp_pc(buf, ep)
    buf.seek(0)
    p2 = read_static_qfp_pc(buf)
    for i in range(6):
        assert np.ndim(p2.mul[i]) == 0
        assert p2.mul[i] == ep.mul[i] and p2.shift[i] == ep.shift[i]
        assert p2.blu_q[i] == ep.blu_q[i]


def test_per_channel_beats_layer_grid_at_int4(float_lists):
    """The point of the feature: per-channel INT4 quantization loses less
    vs the float model than the layer-wide grid, measured as weight-grid
    RMS error (the PSNR-driving quantity the finetune then reduces)."""
    ws, _ = float_lists
    layer = stepw_from_weights(ws, bits=4)
    pc = _table(ws)
    worse = 0
    for i in range(5):
        s_l = layer[i]
        s_c = pc[i].stepw
        q_l = np.clip(np.round(ws[i] / s_l), -8, 7) * s_l
        q_c = np.clip(np.round(ws[i] / s_c), -8, 7) * s_c
        e_l = float(np.sqrt(np.mean((q_l - ws[i]) ** 2)))
        e_c = float(np.sqrt(np.mean((q_c - ws[i]) ** 2)))
        if e_c > e_l * (1 + 1e-9):
            worse += 1
    assert worse == 0, f"{worse} layers quantize worse per-channel"
