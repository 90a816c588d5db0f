"""The stale-quant-table hazard (reference QP22 pickle).

The reference's shipped quant_params22.data carries shift=24 in its output
row — 256x below the scale its own solver derives (quantization.py:50-53),
which silently zeroes the residual: the engine runs, logs healthy PSNR
plumbing, and restores nothing. The loaders must detect-and-warn and offer
the re-solved pair (VERDICT r2 item 7).
"""

import warnings

import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.data import model_files
from qcnn_gpu.quant.params import QuantTable
from qcnn_gpu.testing import asset, synth_engine_params


def test_qp22_pickle_warns_and_fixes():
    with pytest.warns(UserWarning, match="zeroes the residual"):
        t = QuantTable.load_pickle(asset("quant_params22.data"))
    fix = t.last_row_stale()
    assert fix is not None
    assert (fix.mul, fix.shift) == (5, 16)  # the solved pair (stored: 5/24)
    fixed = t.fixed_last_row()
    assert (fixed[5].mul, fixed[5].shift) == (5, 16)
    assert fixed[5].stepw == t[5].stepw  # weight grid untouched
    assert fixed.last_row_stale() is None
    assert fixed.fixed_last_row() is fixed  # healthy table passes through


def test_healthy_tables_do_not_warn():
    # QP27 ships (1, 12) where the solver yields (2, 13) — SAME scale, so a
    # pair-equality check would false-positive; the scale check must not.
    for qp in (27, 32, 37):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = QuantTable.load_pickle(asset(f"quant_params{qp}.data"))
        assert t.last_row_stale() is None


def test_model_file_zeroed_residual_warns(tmp_path):
    # reinstate the stale pair in an otherwise-valid engine model file
    p = synth_engine_params(22)
    p.mul[5], p.shift[5] = 5, 24
    bad = str(tmp_path / "bad.data")
    model_files.write_static_qfp_vect_c(bad, p)
    with pytest.warns(UserWarning, match="restores nothing"):
        model_files.read_static_qfp_vect_c(bad)

    good = str(tmp_path / "good.data")
    model_files.write_static_qfp_vect_c(good, synth_engine_params(37))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model_files.read_static_qfp_vect_c(good)
