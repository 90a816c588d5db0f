"""Solver vs the reference's shipped quant tables (golden data fixtures)."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.quant import (
    BLU_INIT,
    QuantTable,
    solve_concat,
    solve_last,
    solve_layer,
    solve_mul_shift,
    solve_mul_shift_float,
    solve_network,
    stepw_from_weights,
)
from qcnn_gpu.testing import asset

QPS = (22, 27, 32, 37)


@pytest.fixture(params=QPS)
def table(request):
    return request.param, QuantTable.load_pickle(asset(f"quant_params{request.param}.data"))


def test_golden_window_property(table):
    """Every shipped BLU row satisfies the co-design window: the int-domain
    BLU bound requantizes to ~127, i.e. blu_q*mul/2^shift in (127-eps, 127.5]
    (the shipped tables mix two solver generations — pre- and post-recenter
    blu_q — so the lower edge carries the recenter rounding slack of up to
    0.5*mul/2^shift)."""
    qp, t = table
    for row in t.rows[:5]:
        scaled = row.blu_q * row.mul / 2.0**row.shift
        eps = 0.5 * row.mul / 2.0**row.shift + 1e-9
        assert 127.0 - eps < scaled <= 127.5, (qp, row, scaled)


def test_golden_rows_solver_consistent(table):
    """solve_mul_shift on each shipped blu_q lands on the same effective
    scale mul/2^shift (representation may differ across solver generations;
    the scale is what the engine's arithmetic sees)."""
    qp, t = table
    for row in t.rows[:5]:
        mul, shift = solve_mul_shift(row.blu_q)
        eff_solved = mul / 2.0**shift
        eff_golden = row.mul / 2.0**row.shift
        assert abs(eff_solved - eff_golden) / eff_golden < 5e-3, (qp, row, mul, shift)


def test_golden_last_row_scale(table):
    """Last layer: mul/2^shift must equal 255*stepw/ratio within the 2%
    solve tolerance. QP22's shipped row is stale (shift=24 would zero the
    residual; quant/solver.py docstring) — assert the corrected solve
    instead."""
    qp, t = table
    row = t.rows[5]
    if qp == 22:
        row = solve_last(row.ratio, row.stepw)
    eff = row.mul / 2.0**row.shift
    target = 255.0 * row.stepw / row.ratio
    assert abs(eff - target) / target < 0.021, (qp, row)


def test_network_chain_reproduces_ratios(table):
    """Re-solving from the shipped stepw column reproduces the chained
    per-layer input ratios exactly and each row's effective requant gain
    mul/(stepw*2^shift) to ~1e-4 (concat-adjusted branches may pick an
    equivalent (mul, shift) representation)."""
    qp, t = table
    solved = solve_network(t.stepw, BLU_INIT[qp])
    for i in range(6):
        assert solved[i].ratio == pytest.approx(t[i].ratio, rel=1e-9), (qp, i)
    for i in range(5):
        gain_solved = solved[i].mul / (solved[i].stepw * 2.0 ** solved[i].shift)
        gain_golden = t[i].mul / (t[i].stepw * 2.0 ** t[i].shift)
        assert gain_solved == pytest.approx(gain_golden, rel=2e-4), (qp, i)


def test_concat_branches_share_output_scale():
    for qp in QPS:
        t = QuantTable.load_pickle(asset(f"quant_params{qp}.data"))
        solved = solve_network(t.stepw, BLU_INIT[qp])
        for a, b in ((1, 2), (3, 4)):
            ra = solved[a].mul / solved[a].stepw / 2.0 ** solved[a].shift
            rb = solved[b].mul / solved[b].stepw / 2.0 ** solved[b].shift
            assert ra == pytest.approx(rb, rel=1e-12), (qp, a, b)


def test_solve_layer_recenters_blu_to_127():
    row = solve_layer(255.0, 0.008, 0.3)
    assert round(row.blu_adj * row.ratio / row.stepw) == row.blu_q
    assert 127.0 < row.blu_q * row.mul / 2.0**row.shift <= 127.5


def test_solve_concat_equalizes():
    r1, r2 = solve_concat(255.0, 0.009, 0.25, 0.006, 0.18)
    assert r1.mul / r1.stepw / 2.0**r1.shift == pytest.approx(
        r2.mul / r2.stepw / 2.0**r2.shift, rel=1e-12
    )


def test_mul_shift_float_tolerance():
    for ratio in (100.0, 4096.5, 13158.8, 30000.0):
        mul, shift = solve_mul_shift_float(ratio)
        assert abs(2.0**shift / mul - ratio) < 0.02 * ratio


def test_stepw_from_weights_asymmetric():
    w_pos = np.array([0.5, -0.1])
    w_neg = np.array([0.1, -0.64])
    assert stepw_from_weights([w_pos])[0] == pytest.approx(0.5 / 127)
    assert stepw_from_weights([w_neg])[0] == pytest.approx(0.64 / 128)


def test_packed_roundtrip(tmp_path, table):
    qp, t = table
    path = str(tmp_path / "packed.data")
    t.save_packed(path)
    assert QuantTable.load_packed(path) == t
    path2 = str(tmp_path / "pickle.data")
    t.save_pickle(path2)
    assert QuantTable.load_pickle(path2) == t
