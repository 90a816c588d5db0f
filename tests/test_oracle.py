"""Oracle semantics invariants (SURVEY.md §5.1 contract items)."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.models import oracle as O
from qcnn_gpu.testing import synth_dynamic_params, synth_engine_params, synth_frames


def test_preprocess_range():
    x = np.array([[0, 128, 255]], dtype=np.uint8)
    assert (O.preprocess(x) == [[-128, 0, 127]]).all()


def test_conv_int_cross_correlation_same_pad():
    # identity kernel at center tap => conv == input
    x = np.arange(25, dtype=np.int64).reshape(1, 5, 5, 1)
    w = np.zeros((3, 3, 1, 1), dtype=np.int64)
    w[1, 1, 0, 0] = 1
    assert (O.conv_int(x, w) == x).all()
    # cross-correlation orientation: weight at (0,0) reads the up-left pixel
    w2 = np.zeros((3, 3, 1, 1), dtype=np.int64)
    w2[0, 0, 0, 0] = 1
    out = O.conv_int(x, w2)
    assert out[0, 1, 1, 0] == x[0, 0, 0, 0]
    assert out[0, 0, 0, 0] == 0  # zero pad


def test_blu_requant_contract():
    # window: blu_q*mul/2^shift in (127,127.5] => u<=blu_q maps to <=127
    blu_q, mul, shift = 11512, 723, 16  # QP37 C1 row
    u = np.arange(-100, blu_q + 200, dtype=np.int64)
    v = O.blu_requant(u, blu_q, mul, shift)
    assert v.min() == 0 and v.max() == 127
    assert (v[u < 0] == 0).all()
    assert (v[u > blu_q] == 127).all()
    assert v[list(u).index(blu_q)] == 127
    # monotone non-decreasing on the linear span
    lin = v[(u >= 0) & (u <= blu_q)]
    assert (np.diff(lin) >= 0).all()
    # exact bias placement: pre-multiply, integer-divided by mul
    bias = (1 << (shift - 1)) // mul
    uu = 5000
    assert v[list(u).index(uu)] == ((uu + bias) * mul) >> shift


def test_final_residual_negative_floor():
    # arithmetic shift on negative == floor division (C >> on int)
    u = np.array([-(1 << 16), -1, 0, 1], dtype=np.int64)
    mul, shift = 723, 16
    res = O.final_residual_requant(u, mul, shift)
    expected = np.floor((u * mul + (1 << (shift - 1))) / (1 << shift)).astype(np.int64)
    assert (res == expected).all()


def test_round_half_away_div_matches_c_semantics():
    # C: (x + d/2)/d for x>=0, (x - d/2)/d for x<0, trunc toward zero
    d = 7
    xs = np.arange(-50, 50, dtype=np.int64)
    got = O.round_half_away_div(xs, d)
    ref = []
    for x in xs:
        if x >= 0:
            ref.append(int((x + d // 2) / d))
        else:
            ref.append(-int((-x + d // 2) / d))
    assert (got == np.array(ref)).all()
    # half rounds away from zero
    assert O.round_half_away_div(np.array([3]), 6)[0] == 1
    assert O.round_half_away_div(np.array([-3]), 6)[0] == -1


def test_apply_residual_clamps():
    x = np.array([[250, 5, 128]], dtype=np.uint8)
    res = np.array([[10, -10, 1]], dtype=np.int64)
    assert (O.apply_residual(x, res) == [[255, 0, 129]]).all()


def test_step_state_sorting():
    s = O.StepState()
    for v in (5, 9, 2):
        s.insert_w(v)
        s.insert_y(v)
    assert s.stepw == [9, 5, 2]  # descending (insert_w, qvrcnn.cu:305-317)
    assert s.stepy == [2, 5, 9]  # ascending (insert_y, qvrcnn.cu:318-330)


def test_adjust_basic_walk():
    s = O.StepState()
    s.insert_w(10)
    s.insert_y(3)
    b = np.array([7, -7], dtype=np.int64)
    # 7*10=70 -> round-half-away /3 = (70+1)//3 = 23
    out = O.adjust_basic(b, s, 1)
    assert (out == [23, -23]).all()


def test_forward_blu_shapes_and_determinism():
    p = synth_engine_params(37)
    x = synth_frames(2, 48, 64)
    r1 = O.forward_blu(x, p)
    r2 = O.forward_blu(x, p)
    assert r1.shape == x.shape and r1.dtype == np.uint8
    assert (r1 == r2).all()
    # the net is a residual restorer: output should stay close to input
    assert np.mean(np.abs(r1.astype(int) - x.astype(int))) < 32


def test_forward_blu_all_qps():
    x = synth_frames(1, 40, 56)
    for qp in (22, 27, 32, 37):
        p = synth_engine_params(qp)
        r = O.forward_blu(x, p)
        assert r.shape == x.shape


def test_forward_calibrate_runs_and_reports():
    p = synth_dynamic_params(37)
    x = synth_frames(1, 40, 48)
    rec, tel = O.forward_calibrate(x, p)
    assert rec.shape == x.shape
    assert len(tel["max_u"]) == 3
    assert tel["step_y"][0] == O.step_from_max(tel["max_u"][0])


def test_forward_dynamic_hybrid_runs():
    p = synth_engine_params(37)
    x = synth_frames(1, 40, 48)
    rec = O.forward_dynamic_hybrid(x, p)
    assert rec.shape == x.shape


def test_concat_dynamic_steps_common_scale():
    s1, s2 = O.concat_dynamic_steps(10, 1000, 20, 3000)
    # after negotiation the cross products agree approximately:
    # step_w1*step_y2 ~= step_w2*step_y1 (cnn.cu:303-307 comment)
    assert abs(10 * s2 - 20 * s1) <= max(10, 20)
