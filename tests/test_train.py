"""Training stack: float step, quant fine-tune, checkpointing, datasets."""

import numpy as np
import pytest

import jax

from qcnn_gpu.data.datasets import PatchDataset, PrefetchLoader
from qcnn_gpu.models import float_model as FM
from qcnn_gpu.parallel.mesh import make_mesh
from qcnn_gpu.quant.solver import BLU_INIT
from qcnn_gpu.testing import synth_frames
from qcnn_gpu.train import Trainer, TrainConfig, quant_finetune
from qcnn_gpu.train.trainer import make_train_step


def _patch_batches(n_steps, batch=4, side=32, seed=0):
    ori = synth_frames(2, 128, 128, seed=seed)
    anchor = np.clip(
        ori.astype(int) + np.random.default_rng(seed).integers(-5, 6, ori.shape),
        0,
        255,
    ).astype(np.uint8)
    ds = PatchDataset([(ori, anchor)], patch=side, seed=seed)
    return ds, list(ds.batches(batch, n_steps))


def test_float_training_reduces_loss():
    mesh = make_mesh(1, 1)
    cfg = TrainConfig(lr=1e-3, log_every=0)
    tr = Trainer(cfg, mesh=mesh)
    _, batches = _patch_batches(30, batch=8)
    losses = []
    for images, labels in batches:
        tr.params, tr.opt_state, loss = tr.step_fn(tr.params, tr.opt_state, images, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


def test_train_step_sharded_matches_single_device():
    """Same data, same init: (dp=2, sp=2) step == (1,1) step."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    _, batches = _patch_batches(3, batch=4, side=32)
    results = {}
    for dp, sp in ((1, 1), (2, 2)):
        mesh = make_mesh(dp, sp)
        step, opt_init = make_train_step(mesh, lr=1e-3)
        params = FM.init_params(0)
        opt_state = opt_init(params)
        for images, labels in batches:
            params, opt_state, loss = step(params, opt_state, images, labels)
        results[(dp, sp)] = (params, float(loss))
    p1, l1 = results[(1, 1)]
    p2, l2 = results[(2, 2)]
    assert l1 == pytest.approx(l2, rel=1e-4)
    for k in p1:
        np.testing.assert_allclose(p1[k], p2[k], rtol=2e-4, atol=2e-6)


def test_blu_training_runs():
    mesh = make_mesh(1, 1)
    tr = Trainer(TrainConfig(lr=1e-3, log_every=0), mesh=mesh, blu_ub=BLU_INIT[37])
    _, batches = _patch_batches(3, batch=4)
    loss = tr.fit_batches(batches, log_fn=lambda *_: None)
    assert np.isfinite(loss)


def test_quant_finetune_lands_on_grid():
    mesh = make_mesh(1, 1)
    params = FM.init_params(0)
    stepw = [0.01, 0.012, 0.011, 0.003, 0.011, 0.002]
    _, batches = _patch_batches(5, batch=4)
    out = quant_finetune(
        params, stepw, mesh, batches, blu_ub=BLU_INIT[37], lr=1e-4, log_every=0
    )
    from qcnn_gpu.models.topology import QVRCNN_LAYERS

    for i, l in enumerate(QVRCNN_LAYERS):
        w = np.asarray(out[f"w_{l.name}"]) / stepw[i]
        np.testing.assert_allclose(w, np.round(w), atol=1e-4)
        assert np.abs(w).max() <= 128.0 + 1e-6


def test_checkpoint_roundtrip(tmp_path):
    mesh = make_mesh(1, 1)
    tr = Trainer(TrainConfig(log_every=0), mesh=mesh)
    _, batches = _patch_batches(2, batch=4)
    tr.fit_batches(batches, log_fn=lambda *_: None)
    tr.save_checkpoint(str(tmp_path))
    tr2 = Trainer(TrainConfig(log_every=0), mesh=mesh)
    tr2.load_checkpoint(str(tmp_path))
    assert tr2.global_step == tr.global_step
    for k in tr.params:
        assert (np.asarray(tr.params[k]) == np.asarray(tr2.params[k])).all()


def test_patch_dataset_geometry():
    ori = synth_frames(2, 128, 96, seed=1)
    ds = PatchDataset([(ori, ori)], patch=64, seed=0)
    # stride 32: cols=(128-64)//32+1=3, rows=(96-64)//32+1=2, pieces=2*3*2
    assert ds.pieces == 12
    o, a = ds.get_piece(0)
    assert o.shape == (64, 64)
    labels, images = ds.get_batch(5)
    assert labels.shape == (5, 64, 64, 1) and labels.dtype == np.float32


def test_patch_dataset_too_small():
    with pytest.raises(ValueError):
        PatchDataset([(np.zeros((1, 32, 32), np.uint8),) * 2], patch=64)


def test_prefetch_loader_order_and_error():
    items = list(range(20))
    out = list(PrefetchLoader(iter(items), depth=3))
    assert out == items

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchLoader(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError):
        for _ in it:
            pass


def test_predict_uint8_float_path():
    params = FM.init_params(0)
    x = synth_frames(1, 32, 48)
    out = np.asarray(FM.predict_uint8(params, x))
    assert out.shape == x.shape and out.dtype == np.uint8


def test_tiled_float_predict_matches_whole_frame():
    """divided_run analog: tiled prediction == whole-frame, everywhere."""
    params = FM.init_params(1)
    x = synth_frames(1, 70, 90, seed=4)
    whole = np.asarray(FM.predict_uint8(params, x))
    tiled = FM.predict_uint8_tiled(params, x, tile=32, pad=10)
    assert (tiled == whole).all()


def test_trainer_metrics_jsonl(tmp_path):
    import json

    mesh = make_mesh(1, 1)
    tr = Trainer(TrainConfig(lr=1e-3, log_every=1), mesh=mesh)
    _, batches = _patch_batches(3, batch=4)
    path = str(tmp_path / "metrics.jsonl")
    tr.fit_batches(batches, log_fn=lambda *_: None, metrics_path=path)
    rows = [json.loads(l) for l in open(path)]
    assert len(rows) == 3
    assert all("loss" in r and "batch_psnr" in r for r in rows)


def test_image_triplet_dump(tmp_path):
    """The tf.summary.image analog (model.py:61-69): one PNG strip of
    input|output|target per log step."""
    import numpy as np

    from qcnn_gpu.train.trainer import dump_image_triplet

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (32, 40), np.uint8) for _ in range(3)]
    path = dump_image_triplet(str(tmp_path), 7, *imgs)
    assert path.endswith("triplet_0000007.png") or path.endswith(".pgm")
    from PIL import Image

    strip = np.asarray(Image.open(path).convert("L"))
    assert strip.shape == (32, 40 * 3 + 8)
    assert (strip[:, :40] == imgs[0]).all()
    assert (strip[:, 44:84] == imgs[1]).all()
    assert (strip[:, 88:] == imgs[2]).all()
