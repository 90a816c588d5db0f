"""Unified config system + INT4 stretch-variant quantization."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.config import Config, EngineConfig
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.oracle import EngineParams
from qcnn_gpu.quant.solver import BLU_INIT, solve_network, stepw_from_weights
from qcnn_gpu.testing import synth_float_weights, synth_frames


def test_config_roundtrip(tmp_path):
    cfg = Config()
    cfg.engine.impl = "int"
    cfg.engine.qps = [37]
    cfg.train.lr = 5e-4
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    back = Config.load(path)
    assert back.engine.impl == "int" and back.engine.qps == [37]
    assert back.train.lr == 5e-4


def test_config_makes_engine(tmp_path):
    cfg = Config(engine=EngineConfig(impl="int", out_dir=str(tmp_path)))
    eng = cfg.make_engine()
    assert eng.impl == "int"


def test_int4_grid_and_forward():
    ws, bs = synth_float_weights(0)
    stepw4 = stepw_from_weights(ws, bits=4)
    stepw8 = stepw_from_weights(ws, bits=8)
    # int4 steps are ~16x coarser
    for s4, s8 in zip(stepw4, stepw8):
        assert s4 == pytest.approx(s8 * 127 / 7, rel=0.15)
    table = solve_network(stepw4, BLU_INIT[37])
    p = EngineParams.from_float(ws, bs, table, wbits=4)
    for w in p.weights:
        assert w.min() >= -8 and w.max() <= 7  # on the int4 grid
    x = synth_frames(1, 32, 48, seed=1)
    rec = O.forward_blu(x, p)
    assert rec.shape == x.shape
    # still a plausible restorer (bounded residuals)
    assert np.mean(np.abs(rec.astype(int) - x.astype(int))) < 48


def test_int4_runs_through_jax_engine():
    from qcnn_gpu.models.qvrcnn import make_forward

    ws, bs = synth_float_weights(2)
    table = solve_network(stepw_from_weights(ws, bits=4), BLU_INIT[27])
    p = EngineParams.from_float(ws, bs, table, wbits=4)
    run = make_forward(p, impl="int")
    x = synth_frames(1, 24, 40, seed=2)
    assert (np.asarray(run(x)) == O.forward_blu(x, p)).all()
