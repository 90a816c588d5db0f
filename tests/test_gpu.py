"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).

Run on the card: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`, or
as phase 7 of chip_smoke.py. They check what only the GPU's compiler can
show: that cuDNN's int8 and bf16 convs, with whatever algorithms XLA's
autotuner picks at these shapes, stay bit-exact against the oracle.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from qcnn_gpu.data.model_files import read_static_qfp_auto
from qcnn_gpu.engine.mfu import chip_peaks
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models import qvrcnn as M
from qcnn_gpu.testing import ASSETS_DIR, synth_engine_params, synth_frames

pytestmark = pytest.mark.gpu

MODELS = [f"model_q{qp}{s}.data" for qp in (22, 27, 32, 37) for s in ("", "_int4")]


def test_peak_table_knows_this_card():
    int8, bf16, hbm = chip_peaks(jax.devices()[0].device_kind)
    assert int8 > bf16 > 0 and hbm > 0


@pytest.mark.parametrize("name", MODELS)
def test_committed_model_int_exact_on_gpu(name):
    p = read_static_qfp_auto(os.path.join(ASSETS_DIR, "golden", name))
    x = synth_frames(3, 72, 120, seed=len(name))
    x[0] = 255
    got = np.asarray(M.make_forward(p, impl="int")(x))
    assert (got == O.forward_blu(x, p)).all()


def test_bf16_exact_on_gpu():
    p = read_static_qfp_auto(os.path.join(ASSETS_DIR, "golden", "model_q37.data"))
    x = synth_frames(2, 72, 120, seed=3)
    got = np.asarray(M.make_forward(p, impl="bf16")(x))
    assert (got == O.forward_blu(x, p)).all()


def test_split_int_conv_exact_on_gpu():
    """A stage split into input-channel slices (int_conv_groups > 1, the
    route of models outside the bf16 certificate) stays exact."""
    p = synth_engine_params(32)
    mp = dataclasses.replace(M.MergedParams.from_engine(p), int_groups=(1, 2, 3, 2))
    x = synth_frames(2, 48, 64, seed=4)

    @jax.jit
    def run(x_uint8):
        xi = x_uint8[..., None].astype(jax.numpy.int32) - 128
        res = M.residual_blu_merged(xi, mp, "int")
        return M.apply_residual_u8(x_uint8, res)

    assert (np.asarray(run(x)) == O.forward_blu(x, p)).all()
