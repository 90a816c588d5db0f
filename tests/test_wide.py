"""Wide-CNN stretch model (models/wide.py): solver chain, XLA engine,
channel-sharded TP, and the float-train -> quantize -> TP closed loop.

This is the configuration tensor parallelism exists for (SURVEY §2.4 P6,
BASELINE config 5) — exercised here at CPU-affordable channel counts; the
sharding algebra is channel-count-independent (psums rebuild exact int32
accumulators regardless of width).
"""

import numpy as np
import pytest

from qcnn_gpu.models import wide as W
from qcnn_gpu.parallel.mesh import make_mesh
from qcnn_gpu.parallel.tensor import make_tp_wide_forward
from qcnn_gpu.testing import synth_frames


def test_wide_solver_window():
    p = W.synth_wide_params(channels=32, blocks=3, seed=1)
    for blu_q, mul, shift in zip(p.blu_q, p.mul, p.shift):
        scaled = blu_q * mul / 2.0**shift
        assert 126.0 < scaled <= 127.5  # the solve_mul_shift window
        assert shift <= 24  # int32 requant-product headroom


def test_wide_xla_matches_oracle():
    p = W.synth_wide_params(channels=32, blocks=2, seed=2)
    x = synth_frames(2, 24, 40, seed=3)
    run = W.make_wide_forward(p)
    assert (np.asarray(run(x)) == W.forward_wide(x, p)).all()


def test_wide_save_load_roundtrip(tmp_path):
    p = W.synth_wide_params(channels=16, blocks=2, seed=4)
    path = str(tmp_path / "wide.npz")
    p.save(path)
    q = W.WideParams.load(path)
    x = synth_frames(1, 16, 24, seed=5)
    assert (W.forward_wide(x, p) == W.forward_wide(x, q)).all()
    assert q.channels == 16 and q.blocks == 2


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("blocks", [2, 3])  # odd/even: tail row-parallel vs
# replicated (the two sharding terminations)
def test_wide_tp_bit_exact(tp, blocks):
    p = W.synth_wide_params(channels=64, blocks=blocks, seed=6)
    mesh = make_mesh(1, tp)
    run = make_tp_wide_forward(p, mesh, axis="sp")
    x = synth_frames(2, 32, 48, seed=7)
    assert (np.asarray(run(x)) == W.forward_wide(x, p)).all()


def test_wide_tp_realistic_geometry():
    """TP == unsharded at the class-C frame geometry (VERDICT r2 item 5:
    'run at a realistic geometry (>=832x480) on the 8-device CPU mesh').
    Gold is the unsharded XLA graph (itself oracle-certified above); the
    NumPy oracle at this pixel count would need minutes."""
    p = W.synth_wide_params(channels=64, blocks=4, seed=8)
    x = synth_frames(1, 480, 832, seed=9)
    gold = np.asarray(W.make_wide_forward(p)(x))
    run = make_tp_wide_forward(p, make_mesh(1, 8), axis="sp")
    assert (np.asarray(run(x)) == gold).all()


def test_wide_train_quantize_tp_loop():
    """The closed loop: float-train on patches -> solver quantization ->
    INT8 engine == oracle, TP == engine. (The reference's train ->
    quantize -> engine artifact flow, SURVEY §1, applied to the stretch
    family.)"""
    import jax
    import jax.numpy as jnp
    import optax

    channels, blocks = 16, 2
    rng = np.random.default_rng(11)
    shapes = (
        [(3, 3, 1, channels)]
        + [(3, 3, channels, channels)] * blocks
        + [(3, 3, channels, 1)]
    )
    ws = [
        jnp.asarray(rng.normal(0, 0.6 / np.sqrt(s[0] * s[1] * s[2]), s), jnp.float32)
        for s in shapes
    ]
    bs = [jnp.zeros(s[3], jnp.float32) for s in shapes]

    clean = synth_frames(8, 32, 32, seed=12).astype(np.float32)
    noisy = np.clip(
        clean + rng.normal(0, 6, clean.shape), 0, 255
    ).astype(np.float32)
    xn = jnp.asarray((noisy - 128.0) / 255.0)[..., None]
    tgt = jnp.asarray((clean - 128.0) / 255.0)[..., None]

    def loss_fn(params):
        ws, bs = params
        pred = W.float_forward(ws, bs, xn) + xn  # residual add (model.py:56)
        return jnp.mean((pred - tgt) ** 2)

    opt = optax.adam(1e-3)
    params = (ws, bs)
    state = opt.init(params)
    losses = []

    @jax.jit
    def step(params, state):
        l, g = jax.value_and_grad(loss_fn)(params)
        up, state = opt.update(g, state)
        return optax.apply_updates(params, up), state, l

    for _ in range(25):
        params, state, l = step(params, state)
        losses.append(float(l))
    assert losses[-1] < losses[0]  # it trains

    ws_f = [np.asarray(w) for w in params[0]]
    bs_f = [np.asarray(b) for b in params[1]]
    p = W.quantize_wide(ws_f, bs_f, blu=[2.0] * (blocks + 1) + [0.0])
    x = synth_frames(1, 24, 32, seed=13)
    rec = np.asarray(W.make_wide_forward(p)(x))
    assert (rec == W.forward_wide(x, p)).all()
    runt = make_tp_wide_forward(p, make_mesh(1, 4), axis="sp")
    assert (np.asarray(runt(x)) == rec).all()


def test_wide_fp8_psnr_parity():
    """FP8 requant variant (BASELINE config 5 stretch): fp8 weights +
    fp8 inter-layer activations track the float model within a small
    PSNR delta on a restoration task (not bit-exact by design — the
    package's integer paths keep that contract; fp8 trades exactness
    for half-of-bf16 storage)."""
    import jax.numpy as jnp

    from qcnn_gpu.data import yuv
    from qcnn_gpu.models.wide import (
        float_forward,
        make_wide_forward_fp8,
        quantize_wide_fp8,
    )

    rng = np.random.default_rng(5)
    channels, blocks = 32, 2
    shapes = [(3, 3, 1, channels)] + [(3, 3, channels, channels)] * blocks + [
        (3, 3, channels, 1)
    ]
    ws = [
        rng.normal(0, 0.6 / np.sqrt(s[0] * s[1] * s[2]), s).astype(np.float32)
        for s in shapes
    ]
    bs = [rng.normal(0, 0.01, s[3]).astype(np.float32) for s in shapes]

    x = synth_frames(2, 40, 56, seed=9)
    xn = jnp.asarray((x[..., None].astype(np.float32) - 128.0) / 255.0)
    res_f = np.asarray(float_forward([jnp.asarray(w) for w in ws],
                                     [jnp.asarray(b) for b in bs], xn))
    rec_f = np.clip(
        x.astype(np.float32) + np.round(res_f[..., 0] * 255.0), 0, 255
    ).astype(np.uint8)

    run8 = make_wide_forward_fp8(ws, bs)
    rec8 = np.asarray(run8(jnp.asarray(x)))
    assert rec8.shape == x.shape and rec8.dtype == np.uint8
    # fp8 output tracks the float output closely (same restoration)
    assert yuv.psnr(rec8, rec_f) > 40.0
    assert np.abs(rec8.astype(int) - rec_f.astype(int)).max() <= 8
    # the storage claim: fp8 weights are 1 byte/param
    n_params = sum(w.size for w in ws)
    assert run8.weight_bytes == n_params
    # weights really are float8
    w8, scales = quantize_wide_fp8(ws, bs)
    assert all(w.dtype == jnp.float8_e4m3fn for w in w8)
