"""Sharded vs unsharded bit-equality on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from qcnn_gpu.models import oracle as O
from qcnn_gpu.parallel import make_mesh, make_sharded_forward, mesh_shape_for
from qcnn_gpu.parallel.spatial import psnr_sharded
from qcnn_gpu.testing import synth_engine_params, synth_frames


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (8, 1), (4, 2)])
def test_sharded_bit_exact(dp, sp):
    _need_devices(dp * sp)
    p = synth_engine_params(37)
    mesh = make_mesh(dp, sp)
    run = make_sharded_forward(p, mesh, impl="int")
    x = synth_frames(dp * 2, sp * 24, 64, seed=dp * 10 + sp)
    want = O.forward_blu(x, p)
    got = np.asarray(run(x))
    assert (got == want).all(), f"{np.sum(got != want)} mismatches at mesh {dp}x{sp}"


def test_sharded_small_rows_per_device():
    """Shard rows down to barely more than the halo — still exact."""
    _need_devices(8)
    p = synth_engine_params(27)
    mesh = make_mesh(1, 8)
    run = make_sharded_forward(p, mesh, impl="int")
    x = synth_frames(1, 8 * 8, 48, seed=3)  # 8 rows per device, halo 6
    assert (np.asarray(run(x)) == O.forward_blu(x, p)).all()


def test_psnr_sharded_matches_host():
    _need_devices(8)
    from qcnn_gpu.data import yuv

    mesh = make_mesh(2, 4)
    a = synth_frames(2, 4 * 16, 32, seed=1)
    b = synth_frames(2, 4 * 16, 32, seed=2)
    got = float(psnr_sharded(a, b, mesh))
    want = yuv.psnr(a, b)
    assert got == pytest.approx(want, abs=1e-9)


def test_mesh_shape_heuristic():
    assert mesh_shape_for(8, frames=16) == (8, 1)
    assert mesh_shape_for(8, frames=2, rows=1080) == (2, 4)
    dp, sp = mesh_shape_for(8, frames=1, rows=64)
    assert dp == 1 and sp == 1  # too few rows to justify spatial shards


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_tp_int8_engine_bit_exact(tp):
    """TP integrated with the INT8 engine (VERDICT r1 #7): channel-sharded
    Megatron pairs with int32 psums BEFORE the requant epilogues must be
    bit-exact vs the oracle — integer psum is exact, so the epilogue sees
    identical accumulators regardless of tp."""
    _need_devices(tp)
    from qcnn_gpu.parallel.tensor import make_tp_int8_forward

    p = synth_engine_params(32)
    mesh = make_mesh(1, tp)
    run = make_tp_int8_forward(p, mesh, axis="sp")
    x = synth_frames(2, 24, 40, seed=tp)
    want = O.forward_blu(x, p)
    got = np.asarray(run(x))
    assert (got == want).all(), f"tp={tp}: {np.sum(got != want)} mismatches"


def test_tp_conv_pair_matches_unsharded():
    """Channel-sharded conv pair == unsharded (TP analog, demonstration
    scale; an all-channels-on-one-chip psum identity check)."""
    _need_devices(8)
    import jax.numpy as jnp
    from jax import lax

    from qcnn_gpu.parallel.tensor import make_tp_conv_pair

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(1, 16, 24, 8)), jnp.float32)
    w_a = jnp.asarray(rng.normal(size=(3, 3, 8, 32)), jnp.float32)
    b_a = jnp.asarray(rng.normal(size=(32,)), jnp.float32)
    w_b = jnp.asarray(rng.normal(size=(3, 3, 32, 8)), jnp.float32)
    b_b = jnp.asarray(rng.normal(size=(8,)), jnp.float32)

    mesh = make_mesh(1, 8)
    f = make_tp_conv_pair(mesh, axis="sp")
    got = np.asarray(f(x, w_a, b_a, w_b, b_b))

    def conv(x, w):
        return lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        )

    want = np.asarray(conv(jnp.maximum(conv(x, w_a) + b_a, 0.0), w_b) + b_b)
    # f32 summation order differs across the psum split: ~1e-4 abs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dp,sp,sw", [(1, 2, 4), (2, 2, 2), (1, 4, 2)])
def test_sharded_2d_bit_exact(dp, sp, sw):
    """2-D (dp, sp, sw) spatial sharding — rows AND columns halo-exchanged
    (the full generalization of the reference's 2x2 divided_run,
    model.py:235-255) — bit-exact vs the oracle, including the corner
    halos that require diagonal-neighbor data."""
    _need_devices(dp * sp * sw)
    p = synth_engine_params(37)
    mesh = make_mesh(dp, sp, sw=sw)
    run = make_sharded_forward(p, mesh, impl="int")
    x = synth_frames(dp * 2, sp * 24, sw * 40, seed=dp + 10 * sp + 100 * sw)
    want = O.forward_blu(x, p)
    got = np.asarray(run(x))
    assert (got == want).all(), f"{np.sum(got != want)} mismatches at {dp}x{sp}x{sw}"


def test_sharded_2d_4k_geometry():
    """A 4K-class frame over a (1, 2, 4) mesh: >8-way-shardable geometry
    the row-only mesh could not reach with balanced shards; sampled pixel
    equality vs the whole-frame XLA graph (the oracle needs minutes at
    4K; the graph is oracle-certified by test_model_vs_oracle)."""
    _need_devices(8)
    from qcnn_gpu.models.qvrcnn import make_forward

    p = synth_engine_params(22)
    mesh = make_mesh(1, 2, sw=4)
    run = make_sharded_forward(p, mesh, impl="int")
    x = synth_frames(1, 2160, 3840, seed=9)
    got = np.asarray(run(x))
    want = np.asarray(make_forward(p, impl="int")(x))
    assert (got == want).all(), f"{np.sum(got != want)} mismatches at 4K 2-D mesh"


def test_psnr_sharded_2d():
    _need_devices(8)
    from qcnn_gpu.data import yuv

    mesh = make_mesh(2, 2, sw=2)
    a = synth_frames(2, 2 * 16, 2 * 24, seed=4)
    b = synth_frames(2, 2 * 16, 2 * 24, seed=5)
    assert float(psnr_sharded(a, b, mesh)) == pytest.approx(yuv.psnr(a, b), abs=1e-9)


def test_mesh_shape_2d_heuristic():
    assert mesh_shape_for(8, frames=16, cols=1920) == (8, 1, 1)
    # 1 frame, 4K: rows cap sp at 8? rows//sp >= 64 holds to sp=8 -> sw=1
    assert mesh_shape_for(8, frames=1, rows=2160, cols=3840) == (1, 8, 1)
    # few rows force the spatial factor onto columns
    dp, sp, sw = mesh_shape_for(8, frames=1, rows=128, cols=3840)
    assert (dp, sp) == (1, 2) and sw > 1
