"""Pipelined streaming restore (engine/stream.py) — order, exactness,
error propagation, and the Engine.restore_stream integration.

Reference analog: the timed frame loop kernel.cu:89-101 (serialized
memcpy/forward/memcpy) + the double-buffered producer thread of
train_data.py:132-177, combined into one overlapped pipeline.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

import jax

from qcnn_gpu.engine.runner import Engine
from qcnn_gpu.engine.stream import measure_stream_fps, pipeline_restore
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.qvrcnn import make_forward
from qcnn_gpu.testing import synth_engine_params, synth_frames


@pytest.fixture(scope="module")
def setup():
    p = synth_engine_params(37)
    run = make_forward(p, impl="int")
    batches = [synth_frames(2, 48, 64, seed=i) for i in range(5)]
    golds = [O.forward_blu(b, p) for b in batches]
    return p, run, batches, golds


def test_pipeline_restore_order_and_values(setup):
    _, run, batches, golds = setup
    for depth in (1, 2, 4):
        outs = pipeline_restore(run, batches, depth=depth, device=jax.devices()[0])
        assert len(outs) == len(batches)
        for o, g in zip(outs, golds):
            assert (o == g).all()


def test_pipeline_restore_on_output_sink(setup):
    _, run, batches, golds = setup
    got = []
    outs = pipeline_restore(
        run, batches, depth=3, device=jax.devices()[0], on_output=got.append
    )
    assert outs == []
    assert len(got) == len(batches)
    for o, g in zip(got, golds):
        assert (o == g).all()


def test_pipeline_restore_propagates_run_error(setup):
    _, _, batches, _ = setup

    def boom(x):
        raise RuntimeError("kaboom")

    with pytest.raises(RuntimeError, match="kaboom"):
        pipeline_restore(boom, batches, depth=2)


def test_pipeline_restore_propagates_sink_error_without_deadlock(setup):
    """A failing sink must raise, not deadlock the producer against a full
    queue (the fetcher keeps draining after recording the error)."""
    _, run, batches, _ = setup

    def bad_sink(a):
        raise ValueError("sink broke")

    with pytest.raises(ValueError, match="sink broke"):
        pipeline_restore(
            run, batches, depth=1, device=jax.devices()[0], on_output=bad_sink
        )


def test_measure_stream_fps_counts_frames(setup):
    _, run, batches, _ = setup
    fps = measure_stream_fps(run, batches, depth=2, device=jax.devices()[0])
    assert fps > 0


def test_engine_restore_stream_pipelined(setup):
    p, _, _, _ = setup
    eng = Engine(impl="int", batch_frames=3)
    eng.set_model(37, p)
    frames = synth_frames(8, 48, 64, seed=42)  # 3 batches: 3+3+2
    out = eng.restore_stream(frames, qp=37, depth=2)
    assert (out == O.forward_blu(frames, p)).all()
