"""Native C++ IO vs the NumPy semantic definition."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu import native
from qcnn_gpu.data import yuv
from qcnn_gpu.testing import synth_frames


needs_native = pytest.mark.skipif(native.lib() is None, reason="no C++ toolchain")


@needs_native
def test_native_read_matches_numpy(tmp_path):
    y = synth_frames(4, 24, 32, seed=5)
    path = str(tmp_path / "c.yuv")
    yuv.write_y_as_420(path, y)
    nat = native.read_y(path, 24, 32, frames=4)
    assert (nat == y).all()
    part = native.read_y(path, 24, 32, frames=2, start=1)
    assert (part == y[1:3]).all()


@needs_native
def test_native_read_errors(tmp_path):
    y = synth_frames(2, 16, 16, seed=1)
    path = str(tmp_path / "c.yuv")
    yuv.write_y_as_420(path, y)
    with pytest.raises(EOFError):
        native.read_y(path, 16, 16, frames=5)
    with pytest.raises(FileNotFoundError):
        native.read_y(str(tmp_path / "nope.yuv"), 16, 16, frames=1)


@needs_native
def test_native_write_roundtrip(tmp_path):
    y = synth_frames(2, 16, 24, seed=2)
    path = str(tmp_path / "n.yuv")
    assert native.write_y_as_420(path, y)
    assert (yuv.read_y(path, 16, 24) == y).all()
    import os

    assert os.path.getsize(path) == 2 * yuv.frame_size_420(16, 24)


@needs_native
def test_native_psnr_matches_numpy():
    a = synth_frames(2, 32, 32, seed=3)
    b = synth_frames(2, 32, 32, seed=4)
    assert native.psnr(a, b) == pytest.approx(yuv.psnr(a, b), abs=1e-12)
    assert native.psnr(a, a) == float("inf")


@needs_native
def test_read_y_dispatches_to_native(tmp_path):
    """data.yuv.read_y with explicit frames uses the native path; results
    must be identical either way."""
    y = synth_frames(3, 20, 28, seed=6)
    path = str(tmp_path / "d.yuv")
    yuv.write_y_as_420(path, y)
    assert (yuv.read_y(path, 20, 28, frames=3) == y).all()


@needs_native
def test_native_duplex_pack_matches_numpy():
    """The C++ block-sparse delta packer (transport.cpp) must produce
    byte-identical payloads to the NumPy packer that defines the
    semantics — zero, nibble, and raw block classes all engaged, plus a
    ragged tail block (size not a multiple of 256)."""
    from qcnn_gpu.engine.packed import _bucket, _pack_payload_numpy

    rng = np.random.default_rng(11)
    h, w, b = 40, 45, 3  # b*h*w = 5400: 21 blocks + 24-px tail
    bg = rng.integers(0, 256, (h, w), np.uint8)
    refs = np.broadcast_to(bg, (b, h, w)).copy()
    x = refs.copy()
    x[0, 4:20, :] = rng.integers(0, 256, (16, w), np.uint8)  # raw blocks
    x[1] = np.clip(
        x[1].astype(np.int16) + rng.integers(-5, 6, (h, w)), 0, 255
    ).astype(np.uint8)  # nibble blocks
    x[1, 0, 0] = 255 if x[1, 0, 0] < 128 else 0  # a pointwise exception

    pay_c, exc_c = native.duplex_pack(x, refs, _bucket)
    pay_n, exc_n = _pack_payload_numpy(x, refs)
    assert exc_c == exc_n
    for a, bb in zip(pay_c, pay_n):
        assert a.dtype == bb.dtype and a.shape == bb.shape
        assert (a == bb).all()
    # all three classes actually engaged
    nb = -(-x.size // 256)
    assert (pay_c[2] < nb).any() and (pay_c[0] < nb).any() and (pay_c[4] >= 0).any()


@needs_native
def test_native_residual_decode_matches_numpy():
    from qcnn_gpu import native
    from qcnn_gpu.engine.packed import make_packed_restore

    import jax.numpy as jnp

    shift = np.zeros((2, 24, 37), np.int16)  # odd width: nibble padding
    rng = np.random.default_rng(2)
    pos = rng.random(shift.shape) < 0.05
    shift[pos] = rng.integers(-180, 181, int(pos.sum())).astype(np.int16)
    shift[~pos] = rng.integers(-7, 8, int((~pos).sum())).astype(np.int16)
    sj = jnp.asarray(shift)

    def run(x):
        return jnp.clip(x.astype(jnp.int16) + sj, 0, 255).astype(jnp.uint8)

    x = synth_frames(2, 24, 37, seed=13)
    packed, decode = make_packed_restore(run, capacity_frac=0.2)
    fetched = tuple(np.asarray(a) for a in packed(x))
    want = np.asarray(run(x))
    got_native = native.residual_decode(
        x, fetched[0], fetched[1], fetched[2], int(fetched[3])
    )
    assert got_native is not None and (got_native == want).all()
    assert (decode(x, fetched) == want).all()  # public path (native inside)


@needs_native
def test_native_duplex_decode_matches_numpy(monkeypatch):
    """DuplexTransport.receive's C++ decode must be bit-identical to the
    NumPy path across a chained packed stream (incl. exceptions and a
    straddling tail block)."""
    import jax.numpy as jnp

    from qcnn_gpu.engine import packed as P

    rng = np.random.default_rng(17)
    h, w, b = 24, 37, 3  # b*h*w = 2664: 10 blocks + tail
    shift = rng.integers(-30, 31, (b, h, w)).astype(np.int16)

    def run(x):
        return jnp.clip(x.astype(jnp.int16) + jnp.asarray(shift), 0, 255).astype(
            jnp.uint8
        )

    def batches():
        base = rng.integers(0, 256, (h, w), np.uint8)
        out = []
        cur = base.astype(np.int16)
        for _ in range(3 * b):
            cur = np.clip(cur + rng.integers(-4, 5, (h, w)), 0, 255)
            out.append(cur.astype(np.uint8))
        fr = np.stack(out)
        return [fr[i * b : (i + 1) * b] for i in range(3)]

    def drive(force_numpy):
        if force_numpy:
            monkeypatch.setattr(native, "duplex_decode8", lambda *a, **k: None)
        rng2 = np.random.default_rng(17)  # same content both drives
        tr = P.make_duplex_restore(run, capacity_frac=0.2)
        recs = []
        for x in bat:
            recs.append(tr.receive(x, tr.send(x)))
        if force_numpy:
            monkeypatch.undo()
        return recs

    bat = batches()
    recs_native = drive(False)
    recs_numpy = drive(True)
    for a, bb in zip(recs_native, recs_numpy):
        assert (a == bb).all()
    want = [np.clip(x.astype(np.int16) + shift, 0, 255).astype(np.uint8) for x in bat]
    for a, wv in zip(recs_native, want):
        assert (a == wv).all()


@needs_native
def test_native_duplex_predict_matches_numpy():
    from qcnn_gpu.engine.packed import _predict_changed_blocks

    rng = np.random.default_rng(23)
    for h, w, b in ((24, 37, 3), (64, 256, 2), (40, 45, 1)):
        refs = rng.integers(0, 256, (b, h, w), np.uint8)
        x = refs.copy()
        # scattered single-pixel changes + a rectangle
        for _ in range(5):
            f, r, c = rng.integers(0, b), rng.integers(0, h), rng.integers(0, w)
            x[f, r, c] ^= 0x1F
        x[0, 2 : min(10, h), 3 : min(20, w)] ^= 3
        got = native.duplex_predict(x, refs)
        assert got is not None
        bidx_c, nb_c = got
        bidx_n, nb_n = _predict_changed_blocks(x, refs)
        assert nb_c == nb_n
        assert (bidx_c == bidx_n).all()
