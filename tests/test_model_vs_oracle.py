"""JAX XLA engine vs the NumPy oracle: bit-for-bit equality.

This is the central correctness gate: both conv forms of the jitted
program (int, bf16) must reproduce the oracle's integer output EXACTLY on
every pixel, for all four QP tables and the committed trained models,
across the edge cases the GPU route must survive: extreme frames, odd and
band-split geometries, ragged batches.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from qcnn_gpu.data.model_files import read_static_qfp_auto
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models import qvrcnn as M
from qcnn_gpu.testing import ASSETS_DIR, synth_engine_params, synth_frames

IMPLS = ["int", "bf16"]
COMMITTED = [f"model_q{qp}{s}.data" for qp in (22, 27, 32, 37) for s in ("", "_int4")]


@pytest.mark.parametrize("qp", [22, 27, 32, 37])
@pytest.mark.parametrize("merged", [True, False])
def test_int_path_bit_exact(qp, merged):
    p = synth_engine_params(qp)
    x = synth_frames(2, 48, 64, seed=qp)
    want = O.forward_blu(x, p)
    run = M.make_forward(p, impl="int", merged=merged)
    got = np.asarray(run(x))
    assert (got == want).all(), f"QP{qp}: {np.sum(got != want)} mismatched pixels"


@pytest.mark.parametrize("qp", [22, 27, 32, 37])
@pytest.mark.parametrize("merged", [True, False])
def test_bf16_path_bit_exact(qp, merged):
    """bf16 path under the exactness certificate. On CPU XLA still
    emulates bf16 conv with f32 accumulation, so the certificate argument
    holds there too."""
    p = synth_engine_params(qp)
    assert M.certify_exact_bf16(p), "synth params must satisfy the certificate"
    x = synth_frames(1, 40, 56, seed=qp + 10)
    want = O.forward_blu(x, p)
    run = M.make_forward(p, impl="bf16", merged=merged)
    got = np.asarray(run(x))
    assert (got == want).all(), f"QP{qp}: {np.sum(got != want)} mismatched pixels"


def test_merged_weights_construction():
    """Merged kernels: zero-padded smaller kernels, concat-ordered channels,
    per-channel requant vectors matching the per-branch scalars."""
    p = synth_engine_params(37)
    mp = M.MergedParams.from_engine(p)
    w2 = np.asarray(mp.w_i8[1])
    assert w2.shape == (5, 5, 64, 48)
    # C2_1's 3x3 sits centered in the 5x5, ring is zero
    assert (w2[1:4, 1:4, :, :32] == p.weights[1]).all()
    assert (w2[0, :, :, :32] == 0).all() and (w2[:, 0, :, :32] == 0).all()
    assert (w2[:, :, :, 32:] == p.weights[2]).all()
    w3 = np.asarray(mp.w_i8[2])
    assert (w3[:, :, :, :16] == p.weights[3]).all()
    assert (w3[1, 1, :, 16:] == p.weights[4][0, 0]).all()
    assert (w3[0, :, :, 16:] == 0).all()
    # per-channel vectors carry the branch scalars
    assert (np.asarray(mp.mul[1])[:32] == p.mul[1]).all()
    assert (np.asarray(mp.mul[1])[32:] == p.mul[2]).all()
    assert (np.asarray(mp.shift[2])[:16] == p.shift[3]).all()


def test_exactness_bounds_reasonable():
    p = synth_engine_params(37)
    bounds = M.exactness_bounds(p)
    assert len(bounds) == 6
    assert all(0 < b < (1 << 24) for b in bounds)
    # and the bound really bounds observed accumulators
    x = synth_frames(1, 32, 32)
    _, inter = O.forward_blu(x, p, collect_intermediates=True)
    for key, idx in (("u1", 0), ("u2_1", 1), ("u2_2", 2), ("u3_1", 3), ("u3_2", 4), ("u4", 5)):
        assert int(np.abs(inter[key]).max()) <= bounds[idx]


def _extreme(kind, h, w):
    if kind == "zeros":
        return np.zeros((1, h, w), np.uint8)
    if kind == "full":
        return np.full((1, h, w), 255, np.uint8)
    return (np.indices((h, w)).sum(0) % 2 * 255).astype(np.uint8)[None]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["zeros", "full", "checker"])
def test_adversarial_extreme_frames(kind, impl):
    """All-0 / all-255 / checkerboard frames stress the clamp branches."""
    p = synth_engine_params(32)
    x = _extreme(kind, 32, 48)
    got = np.asarray(M.make_forward(p, impl=impl)(x))
    assert (got == O.forward_blu(x, p)).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("h,w", [(37, 53), (5, 7), (1, 33), (61, 17)])
def test_odd_geometry(h, w, impl):
    """Odd shapes, down to a single row, stay exact (SAME pad edges)."""
    p = synth_engine_params(27)
    x = synth_frames(1, h, w, seed=h * w)
    assert (np.asarray(M.make_forward(p, impl=impl)(x)) == O.forward_blu(x, p)).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [1, 3, 5])
def test_batch_sizes(n, impl):
    """Ragged batches (the stream's tail) are exact frame by frame."""
    p = synth_engine_params(37)
    x = synth_frames(n, 24, 40, seed=n)
    assert (np.asarray(M.make_forward(p, impl=impl)(x)) == O.forward_blu(x, p)).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("h,w", [(40, 60), (35, 56), (16, 20)])
def test_band_split_geometries(h, w, impl):
    """Heights that do not split evenly into row bands and widths off any
    power-of-two tile, at the band edge cases row tiling has to get right."""
    p = synth_engine_params(22)
    x = synth_frames(2, h, w, seed=h + w)
    assert (np.asarray(M.make_forward(p, impl=impl)(x)) == O.forward_blu(x, p)).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", COMMITTED)
def test_committed_models_bit_exact(name, impl):
    """The committed trained INT8 and INT4 (scalar and per-channel) models,
    both conv forms, on a frame with saturated rows."""
    p = read_static_qfp_auto(os.path.join(ASSETS_DIR, "golden", name))
    x = synth_frames(2, 40, 56, seed=len(name))
    x[0, :4] = 255
    x[1, -4:] = 0
    got = np.asarray(M.make_forward(p, impl=impl)(x))
    assert (got == O.forward_blu(x, p)).all()


def _uncertified_params():
    """QP32 synth params with C2_2 (5x5x64) weights pushed to +-127: the
    worst-case accumulator exceeds 2^24, outside the bf16 certificate."""
    p = synth_engine_params(32)
    w = np.where(np.random.default_rng(0).random(p.weights[2].shape) < 0.5, 127, -127)
    weights = list(p.weights)
    weights[2] = w.astype(p.weights[2].dtype)
    return dataclasses.replace(p, weights=weights)


def test_int_conv_groups():
    """1 slice for every certified model; 2 for the widened S2; S1 (one
    input channel) never needs a split."""
    p = synth_engine_params(37)
    assert M.MergedParams.from_engine(p).int_groups == (1, 1, 1, 1)
    q = _uncertified_params()
    assert not M.certify_exact_bf16(q)
    assert M.MergedParams.from_engine(q).int_groups == (1, 2, 1, 1)
    assert M.ModelParams.from_engine(q).int_groups == (1, 1, 2, 1, 1, 1)


def test_split_int_conv_exact_above_2_24():
    """A conv whose sum exceeds 2^24 and is odd (not representable in f32)
    comes out exact through the int_conv_groups slices."""
    w = np.full((5, 5, 64, 2), 127, np.int8)
    w[0, 0, 0, 0] = 126
    x = np.full((1, 5, 5, 64), 127, np.int8)
    g = M.int_conv_groups(w, 127)
    assert g == 2
    got = np.asarray(M._conv_int(x, w, np.zeros(2, np.int32), g))
    want = 127 * 127 * 1600 - 127  # centre pixel: every tap inside the frame
    assert want > (1 << 24) and want % 2 == 1
    assert int(got[0, 2, 2, 0]) == want
    assert int(got[0, 2, 2, 1]) == want + 127


@pytest.mark.parametrize("merged", [True, False])
def test_uncertified_model_exact_through_int(merged):
    p = _uncertified_params()
    run = M.make_forward(p, merged=merged)
    assert run.impl == "int"
    x = synth_frames(2, 24, 32, seed=5)
    assert (np.asarray(run(x)) == O.forward_blu(x, p)).all()


def test_bf16_refuses_uncertified_model():
    with pytest.raises(ValueError, match="certificate"):
        M.make_forward(_uncertified_params(), impl="bf16")


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_platform_route_selection(monkeypatch, backend):
    """'auto' resolves to the int form on the GPU (measured the faster)
    and on the CPU; explicit forms pass through."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    mp = M.ModelParams.from_engine(synth_engine_params(37))
    assert M.resolve_impl("auto", mp) == "int"
    assert M.resolve_impl("bf16", mp) == "bf16"
    assert M.make_forward(synth_engine_params(37)).impl == "int"


@pytest.mark.parametrize("impl", ["xla", "pallas3", ""])
def test_unknown_impl_raises(impl):
    mp = M.ModelParams.from_engine(synth_engine_params(37))
    with pytest.raises(ValueError, match="unknown conv impl"):
        M.resolve_impl(impl, mp)
