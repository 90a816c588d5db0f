"""Packed-residual D2H transport (engine/packed.py): bit-exactness incl.
exception handling, overflow detection, and the pipelined streaming path."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.engine.packed import (
    make_packed_restore,
    measure_stream_fps_packed,
    packed_roundtrip_bytes,
)
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.qvrcnn import make_forward
from qcnn_gpu.testing import synth_engine_params, synth_frames


def test_packed_roundtrip_bit_exact_engine():
    p = synth_engine_params(37)
    run = make_forward(p, impl="int")
    x = synth_frames(3, 48, 64, seed=4)
    packed, decode = make_packed_restore(run)
    rec = decode(x, packed(x))
    assert (rec == O.forward_blu(x, p)).all()


@pytest.mark.parametrize("w", [64, 63])  # odd width exercises nibble padding
def test_packed_exceptions_exact(w):
    """A synthetic restorer with large residuals: every |diff|>7 pixel must
    ride the exception list and decode exactly."""
    import jax.numpy as jnp

    shift = np.zeros((2, 32, w), np.int16)
    rng = np.random.default_rng(0)
    pos = rng.random((2, 32, w)) < 0.03
    shift[pos] = rng.integers(-200, 201, int(pos.sum())).astype(np.int16)
    shift[~pos] = rng.integers(-7, 8, int((~pos).sum())).astype(np.int16)
    shift_j = jnp.asarray(shift)

    def run(x):
        return jnp.clip(x.astype(jnp.int16) + shift_j, 0, 255).astype(jnp.uint8)

    x = synth_frames(2, 32, w, seed=9)
    want = np.clip(x.astype(np.int16) + shift, 0, 255).astype(np.uint8)
    packed, decode = make_packed_restore(run, capacity_frac=0.1)
    assert (decode(x, packed(x)) == want).all()


def test_packed_overflow_raises_not_corrupts():
    import jax.numpy as jnp

    def run(x):  # every pixel overflows the nibble range
        return jnp.clip(x.astype(jnp.int16) + 100, 0, 255).astype(jnp.uint8)

    x = np.full((1, 64, 64), 10, np.uint8)
    packed, decode = make_packed_restore(run, capacity_frac=1e-4)
    with pytest.raises(OverflowError):
        decode(x, packed(x))


def test_packed_streaming_path():
    """The pipelined loop with packed D2H + in-window host decode restores
    every batch bit-exactly (decode runs on the fetcher thread)."""
    p = synth_engine_params(32)
    run = make_forward(p, impl="int")
    batches = [synth_frames(2, 32, 48, seed=s) for s in range(3)]
    packed, decode = make_packed_restore(run)

    recs = {}
    orig_decode = decode

    def recording_decode(x, fetched):
        rec = orig_decode(x, fetched)
        recs[len(recs)] = rec
        return rec

    fps = measure_stream_fps_packed(packed, recording_decode, batches, depth=2)
    assert fps > 0 and len(recs) == 3
    for i, b in enumerate(batches):
        assert (recs[i] == O.forward_blu(b, p)).all()


def test_packed_roundtrip_bytes_halves_d2h():
    h2d, d2h = packed_roundtrip_bytes((16, 1080, 1920))
    assert h2d == 16 * 1080 * 1920
    assert d2h < 0.55 * h2d  # ~0.5 B/px + exception slots


def _video_like_batches(n_batches, b, h, w, seed=0, jump=6):
    """Temporally correlated uint8 batches: a random base plus a slowly
    drifting signal, with occasional large jumps (nibble exceptions)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.int16)
    frames = []
    cur = base
    for _ in range(n_batches * b):
        step = rng.integers(-3, 4, (h, w), np.int16)
        big = rng.random((h, w)) < 0.01
        step[big] = rng.integers(-60, 61, int(big.sum())).astype(np.int16)
        cur = np.clip(cur + step, 0, 255)
        frames.append(cur.astype(np.uint8))
    fr = np.stack(frames)
    return [fr[i * b : (i + 1) * b] for i in range(n_batches)]


def test_duplex_roundtrip_bit_exact_chain():
    """Duplex transport (sparse temporal-delta H2D + predicted-sparse
    residual-delta D2H) decodes bit-exactly across a chained sequence."""
    from qcnn_gpu.engine.packed import make_duplex_restore

    p = synth_engine_params(37)
    run = make_forward(p, impl="int")
    batches = _video_like_batches(3, 2, 32, 49, seed=5)  # odd width
    tr = make_duplex_restore(run, capacity_frac=0.1)
    kinds = []
    for x in batches:
        item = tr.send(x)
        kinds.append(item[0])
        rec = tr.receive(x, item)
        assert (rec == O.forward_blu(x, p)).all()
    assert kinds[0] == "full" and "packed" in kinds[1:]
    # byte economics are asserted at realistic scale in
    # test_duplex_block_sparse_static_scene (the fixed exception-capacity
    # floor dominates at toy geometry)


def test_duplex_capacity_overflow_goes_full():
    """A batch whose temporal deltas defeat the format must ship
    full-frame (lossless fallback), never a corrupted packed batch."""
    from qcnn_gpu.engine.packed import make_duplex_restore

    rng = np.random.default_rng(1)
    # > 1024 (the capacity floor) exceptional pixels: uncorrelated frames
    a = rng.integers(0, 256, (2, 64, 64), np.uint8)
    b = rng.integers(0, 256, (2, 64, 64), np.uint8)
    tr = make_duplex_restore(lambda x: x, capacity_frac=1e-4)
    k0 = tr.send(a)[0]
    k1 = tr.send(b)[0]
    assert (k0, k1) == ("full", "full")


def test_duplex_residual_overflow_dense_fallback():
    """A residual delta beyond int8 sets the device-side overflow flag
    and receive falls back to the dense recon fetch — bit-exact, never
    an error upward."""
    import jax.numpy as jnp

    from qcnn_gpu.engine.packed import make_duplex_restore

    rng = np.random.default_rng(4)
    h, w, b = 64, 64, 2
    bg = rng.integers(0, 128, (h, w), np.uint8)

    flip = {"on": False}

    def run(x):  # a restorer whose residual JUMPS by >127 when armed
        if flip["on"]:
            return jnp.clip(x.astype(jnp.int16) + 200, 0, 255).astype(jnp.uint8)
        return x

    tr = make_duplex_restore(run)
    x0 = np.broadcast_to(bg, (b, h, w)).copy()
    assert (tr.receive(x0, tr.send(x0)) == x0).all()
    x1 = x0.copy()
    x1[:, 10:20, 10:20] = rng.integers(0, 128, (b, 10, 10), np.uint8)
    flip["on"] = True  # rd = res - 0 = ~+200 > 127 in predicted blocks
    item = tr.send(x1)
    assert item[0] == "packed"
    rec = tr.receive(x1, item)
    want = np.clip(x1.astype(np.int16) + 200, 0, 255).astype(np.uint8)
    assert (rec == want).all()
    # chain continues exactly after the fallback
    x2 = x1.copy()
    x2[:, 30:40, 30:40] = rng.integers(0, 128, (b, 10, 10), np.uint8)
    assert (tr.receive(x2, tr.send(x2)) == np.clip(
        x2.astype(np.int16) + 200, 0, 255
    ).astype(np.uint8)).all()


def test_duplex_streaming_loop_bit_exact():
    from qcnn_gpu.engine.packed import (
        make_duplex_restore,
        measure_stream_fps_duplex,
    )

    p = synth_engine_params(27)
    run = make_forward(p, impl="int")
    batches = _video_like_batches(4, 2, 32, 48, seed=7)
    tr = make_duplex_restore(run, capacity_frac=0.05)
    recs = {}

    fps = measure_stream_fps_duplex(
        tr, batches, depth=2, on_output=lambda r: recs.__setitem__(len(recs), r)
    )
    assert fps > 0 and len(recs) == 4
    for i, x in enumerate(batches):
        assert (recs[i] == O.forward_blu(x, p)).all()


def test_duplex_block_sparse_static_scene():
    """Static background + fast uncorrelated moving object: zero blocks
    ship nothing in EITHER direction — wire bytes land far below the raw
    frames while staying bit-exact."""
    from qcnn_gpu.engine.packed import make_duplex_restore

    rng = np.random.default_rng(3)
    h, w, b = 128, 512, 2
    bg = rng.integers(0, 256, (h, w), np.uint8)
    batches = []
    for j in range(3):
        fr = np.broadcast_to(bg, (b, h, w)).copy()
        for i in range(b):
            x0 = ((j * b + i) * 16) % (w - 16)
            fr[i, 8:24, x0 : x0 + 16] = rng.integers(0, 256, (16, 16), np.uint8)
        batches.append(fr)
    tr = make_duplex_restore(lambda x: x)
    for j, x in enumerate(batches):
        item = tr.send(x)
        rec = tr.receive(x, item)
        assert (rec == x).all()  # identity restorer: rec == x
        if j > 0:
            assert item[0] == "packed"
            assert item[3].size > 0  # predicted block list engaged
            assert tr.stats["h2d_bytes"][-1] < 0.6 * x.nbytes
            assert tr.stats["d2h_bytes"][-1] < 0.6 * x.nbytes
    assert tr.stats["h2d_bytes"][0] == batches[0].nbytes  # cold full


def test_duplex_prediction_is_sound_vs_receptive_field():
    """The predicted-changed-block set must cover every pixel the real
    net's residual can change: run the INT engine (receptive radius 6)
    on two frames differing in ONE pixel and assert the un-predicted
    region decodes identically anyway (it is exactly zero delta)."""
    from qcnn_gpu.engine.packed import make_duplex_restore

    p = synth_engine_params(32)
    run = make_forward(p, impl="int")
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (40, 64), np.uint8)
    x0 = np.broadcast_to(base, (2, 40, 64)).copy()
    x1 = x0.copy()
    x1[:, 20, 30] ^= 0x55  # a single changed pixel per frame
    tr = make_duplex_restore(run)
    assert (tr.receive(x0, tr.send(x0)) == O.forward_blu(x0, p)).all()
    item = tr.send(x1)
    assert item[0] == "packed"
    assert (tr.receive(x1, item) == O.forward_blu(x1, p)).all()


def test_duplex_bytes_roundtrip_quarters_the_wire():
    from qcnn_gpu.engine.packed import duplex_roundtrip_bytes

    h2d, d2h = duplex_roundtrip_bytes((16, 1080, 1920))
    raw = 16 * 1080 * 1920
    assert h2d + d2h < 1.3 * raw  # upper bounds; measured lands far lower
