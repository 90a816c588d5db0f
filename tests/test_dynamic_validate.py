"""Device dynamic path vs oracle; validation tooling; distributed runner."""

import numpy as np
import pytest

import jax

from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.qvrcnn_dynamic import make_dynamic_forward
from qcnn_gpu.testing import (
    load_table,
    synth_dynamic_params,
    synth_engine_params,
    synth_float_weights,
    synth_frames,
)


def test_dynamic_jax_bit_exact_and_telemetry():
    p = synth_dynamic_params(37)
    run = make_dynamic_forward(p)
    for seed in (1, 2):
        x = synth_frames(1, 40, 48, seed=seed)
        rec, tel = run(x)
        want, wtel = O.forward_calibrate(x, p)
        assert (np.asarray(rec) == want).all()
        assert int(tel["max_u"][0]) == wtel["max_u"][0]
        assert tuple(int(v) for v in tel["step_y"][1]) == wtel["step_y"][1]
        assert tuple(int(v) for v in tel["max_u"][2]) == wtel["max_u"][2]


def test_dynamic_b_adj_telemetry_matches_oracle(tmp_path):
    """save_b_adj analog: device b_adj telemetry == oracle's adjusted
    biases, and the binary writer/reader roundtrips (qvrcnn.cu:288-304)."""
    from qcnn_gpu.engine.calibrate import read_b_adj, save_b_adj

    p = synth_dynamic_params(32)
    run = make_dynamic_forward(p)
    x = synth_frames(1, 40, 48, seed=5)
    _, tel = run(x)
    _, wtel = O.forward_calibrate(x, p)
    for dev, want in zip(tel["b_adj"], wtel["b_adj"]):
        assert (np.asarray(dev, dtype=np.int64) == want).all()
    path = str(tmp_path / "b_adj.data")
    save_b_adj(path, [np.asarray(v) for v in tel["b_adj"]])
    save_b_adj(path, [np.asarray(v) for v in tel["b_adj"]])  # append mode
    records = read_b_adj(path)
    assert len(records) == 2
    for rec, want in zip(records[1], wtel["b_adj"]):
        assert (rec == want.astype(np.float32)).all()


def test_hybrid_device_twin_bit_exact():
    """Device twin of the committed hybrid forward() (qvrcnn.cu:82-167)
    == oracle.forward_dynamic_hybrid, including the int8 wraps."""
    from qcnn_gpu.models.qvrcnn_dynamic import make_hybrid_forward

    p = synth_engine_params(22)
    run = make_hybrid_forward(p)
    for seed in (1, 4):
        x = synth_frames(2, 40, 48, seed=seed)
        rec, max_u = run(x)
        want = O.forward_dynamic_hybrid(x, p)
        assert (np.asarray(rec) == want).all()
        # max_u telemetry = abs-max of the C1 accumulator (save_steps analog)
        u1 = O.conv_int(O.preprocess(x[..., None]), p.weights[0], p.biases[0])
        assert int(max_u) == int(np.max(np.abs(u1)))


def test_conv_validation_close_for_consistent_model():
    """Quantizing a float model with its own table: the float-scaled
    accumulators must track the engine accumulators to within accumulated
    quantization error (layer-relative)."""
    from qcnn_gpu.engine.validate import conv_validation
    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.models.oracle import EngineParams

    ws, bs = synth_float_weights(0)
    table = load_table(37)
    params = FM.lists_to_params(ws, bs)
    ep = EngineParams.from_float(ws, bs, table)
    frames = synth_frames(1, 32, 48, seed=3)
    diffs = conv_validation(params, table, ep, frames)
    assert [d.name for d in diffs] == ["C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4"]
    # weight rounding injects ~0.5*stepw per tap; relative to the layer's
    # accumulator scale (blu_q) the tracking error stays small for C1 and
    # bounded for deeper layers where it compounds. A numerically broken
    # engine (wrong mul/shift/layout) shows up as O(1) relative error.
    rel = [d.max_abs_diff / max(t.blu_q, 1000) for d, t in zip(diffs, table)]
    assert rel[0] < 0.1, (rel, diffs[0])
    assert all(r < 0.6 for r in rel), rel
    for d in diffs:
        assert np.isfinite(d.max_abs_diff)
        assert d.engine_corner.shape == (5, 5)


def test_viewmem_report_and_dump(tmp_path):
    from qcnn_gpu.engine.validate import dump_features, viewmem_report

    p = synth_engine_params(27)
    frames = synth_frames(1, 24, 32, seed=1)
    rep = viewmem_report(p, frames)
    assert "== C1 ==" in rep and "mul:" in rep and "== C4 ==" in rep
    feats = dump_features(p, frames, str(tmp_path / "feature_map.data"))
    assert feats["blu1"].shape == (1, 24, 32, 64)
    assert feats["blu3_2"].shape == (1, 24, 32, 32)
    import os

    total = sum(np.asarray(v).size for v in feats.values())
    assert os.path.getsize(tmp_path / "feature_map.data") == 4 * total


def test_distributed_runner_single_process():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from qcnn_gpu.parallel.distributed import DistributedRunner, global_mesh, initialize

    initialize()  # no-op single-process
    mesh = global_mesh(frames_hint=4, rows_hint=64)
    p = synth_engine_params(37)
    runner = DistributedRunner(p, mesh=mesh, impl="int")
    dp, sp = mesh.devices.shape
    x = synth_frames(dp * 2, sp * 32, 48, seed=7)
    rec = runner.restore(x)
    assert (rec == O.forward_blu(x, p)).all()
    ori = synth_frames(dp * 2, sp * 32, 48, seed=8)
    from qcnn_gpu.data import yuv

    assert runner.psnr(rec, ori) == pytest.approx(yuv.psnr(rec, ori), abs=1e-9)
