"""Engine runner + calibration + CLI end-to-end on temp files."""

import json
import os

import numpy as np
import pytest

from qcnn_gpu.data import model_files, yuv
from qcnn_gpu.engine import Engine
from qcnn_gpu.models import oracle as O
from qcnn_gpu.testing import synth_engine_params, synth_frames


@pytest.fixture
def clip(tmp_path):
    ori = synth_frames(3, 48, 64, seed=11)
    anchor = np.clip(
        ori.astype(int) + np.random.default_rng(1).integers(-4, 5, ori.shape), 0, 255
    ).astype(np.uint8)
    ori_p = str(tmp_path / "ori.yuv")
    anc_p = str(tmp_path / "anchor.yuv")
    yuv.write_y_as_420(ori_p, ori)
    yuv.write_y_as_420(anc_p, anchor)
    return ori_p, anc_p, ori, anchor


def test_run_sequence_logs_and_matches_oracle(tmp_path, clip):
    ori_p, anc_p, ori, anchor = clip
    p = synth_engine_params(37)
    model_p = str(tmp_path / "m.data")
    model_files.write_static_qfp_vect_c(model_p, p)

    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.load_model(37, model_p)
    rec = eng.run_sequence(
        "testclip", ori_p, anc_p, 48, 64, qp=37, frames=3,
        recon_path=str(tmp_path / "recon.yuv"),
    )
    # recon on disk matches the oracle bit-for-bit
    recon = yuv.read_y(str(tmp_path / "recon.yuv"), 48, 64)
    want = O.forward_blu(anchor, p)
    assert (recon == want).all()
    assert rec.psnr_after == yuv.psnr(want, ori)
    # all three metric sinks written
    assert os.path.exists(tmp_path / "runs.jsonl")
    assert os.path.exists(tmp_path / "log.txt")
    got = json.loads(open(tmp_path / "runs.jsonl").read().splitlines()[-1])
    assert got["sequence"] == "testclip" and got["qp"] == 37
    binary = model_files.read_psnr_goldens(str(tmp_path / "recon_psnr.data"))
    assert binary[-1] == pytest.approx(rec.psnr_after)


def test_restore_stream_equals_restore(clip, tmp_path):
    _, _, _, anchor = clip
    p = synth_engine_params(27)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(27, p)
    a = eng.restore(anchor, 27)
    b = eng.restore_stream(anchor, 27)
    assert (a == b).all()


def test_missing_model_raises(tmp_path):
    eng = Engine(out_dir=str(tmp_path))
    with pytest.raises(KeyError):
        eng.restore(np.zeros((1, 16, 16), np.uint8), 99)


def test_calibration_pipeline(tmp_path):
    """float params -> 3-sigma BLU -> table -> int model -> runs bit-exact."""
    from qcnn_gpu.engine import calibrate as C
    from qcnn_gpu.models import float_model as FM

    params = FM.init_params(3)
    sample = synth_frames(1, 48, 64, seed=5)
    blu = C.calibrate_blu_bounds(params, sample)
    assert len(blu) == 6 and blu[5] == 0.0 and all(b > 0 for b in blu[:5])
    table = C.solve_table(params, blu_bounds=blu)
    for row in table.rows[:5]:
        # recentered blu_q can sit below 127 by up to half a requant step
        scaled = row.blu_q * row.mul / 2.0**row.shift
        eps = 0.5 * row.mul / 2.0**row.shift + 1e-9
        assert 127.0 - eps < scaled <= 127.5
    ep = C.quantize_model(params, table)
    eng = Engine(impl="int", out_dir=str(tmp_path))
    eng.set_model(0, ep)
    out = eng.restore(sample, 0)
    assert (out == O.forward_blu(sample, ep)).all()


def test_calibrate_dynamic_telemetry():
    from qcnn_gpu.engine.calibrate import calibrate_dynamic
    from qcnn_gpu.testing import synth_dynamic_params

    p = synth_dynamic_params(37)
    frames = synth_frames(2, 32, 48, seed=2)
    maxima, tel = calibrate_dynamic(p, frames)
    assert len(maxima) == 3 and len(tel) == 2
    assert all(m > 0 for m in maxima)


def test_cli_run_and_convert(tmp_path, clip, capsys):
    from qcnn_gpu import cli

    ori_p, anc_p, _, anchor = clip
    p = synth_engine_params(37)
    hwcn = str(tmp_path / "m.hwcn")
    vect = str(tmp_path / "m.vectc")
    model_files.write_static_qfp_hwcn(hwcn, p)

    rc = cli.main(
        ["convert", "--infile", hwcn, "--informat", "hwcn", "--outfile", vect, "--outformat", "vect_c"]
    )
    assert rc == 0
    q = model_files.read_static_qfp_vect_c(vect)
    assert (q.weights[0] == p.weights[0]).all()

    rc = cli.main(
        [
            "run", "--ori", ori_p, "--anchor", anc_p, "--height", "48", "--width", "64",
            "--frames", "3", "--model", vect, "--qp", "37", "--impl", "int",
            "--out-dir", str(tmp_path), "--recon", str(tmp_path / "r.yuv"),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "after quantized net" in out
    recon = yuv.read_y(str(tmp_path / "r.yuv"), 48, 64)
    assert (recon == O.forward_blu(anchor, p)).all()


def test_manifest_roundtrip(tmp_path):
    from qcnn_gpu.data.manifest import JCTVC_SEQUENCES, load_manifest, save_manifest

    assert len(JCTVC_SEQUENCES) == 18
    path = str(tmp_path / "m.json")
    save_manifest(path, JCTVC_SEQUENCES[:3])
    back = load_manifest(path)
    assert back == JCTVC_SEQUENCES[:3]
    assert JCTVC_SEQUENCES[0].anchor_path("/d", 22).endswith(
        "Traffic_intra_main_HM16.0_anchor_Q22.yuv"
    )

def test_tiled_restore_bit_exact():
    """Host halo tiling (engine/tiled.py) == whole-frame, every pixel,
    including ragged grids (H, W not multiples of the tile), one-axis
    tiling, and tiles larger than the frame."""
    from qcnn_gpu.engine.tiled import restore_tiled

    p = synth_engine_params(37)
    frames = synth_frames(2, 100, 130, seed=3)
    whole = O.forward_blu(frames, p)
    run = lambda t: O.forward_blu(np.asarray(t), p)  # noqa: E731
    for th, tw in ((48, 64), (50, 130), (100, 57), (128, 256), (30, 200), (17, 23)):
        got = restore_tiled(run, frames, tile_h=th, tile_w=tw)
        assert (got == whole).all(), (th, tw)


def test_tiled_restore_halo_guard():
    from qcnn_gpu.engine.tiled import restore_tiled

    with pytest.raises(ValueError):
        restore_tiled(lambda t: t, synth_frames(1, 64, 64, seed=1), halo=3)


def test_warmup_covers_streaming_shapes(clip, tmp_path):
    """r2 timing bug: warmup always warmed batch 1, so run_sequence
    compiled the batch_frames-sized program INSIDE the timed region.
    Every shape restore_stream dispatches (full batch + ragged tail) must
    be dispatched by warmup first."""
    _, _, _, anchor = clip  # 3 frames
    p = synth_engine_params(37)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(37, p)

    seen = []
    orig = eng._run
    eng._run = lambda qp, frames: (seen.append(frames.shape), orig(qp, frames))[1]

    eng.warmup(37, 48, 64, frames=3)
    warm = set(seen)
    assert warm == {(2, 48, 64), (1, 48, 64)}  # full batch AND tail

    seen.clear()
    eng.restore_stream(anchor, 37)
    assert set(seen) <= warm, f"unwarmed shapes dispatched: {set(seen) - warm}"

    # frames < batch_frames: only the small shape is warmed (not batch 2)
    seen.clear()
    eng.warmup(37, 48, 64, frames=1)
    assert set(seen) == {(1, 48, 64)}


def test_restore_stream_duplex_bit_exact(tmp_path):
    """transport='duplex' (block-sparse temporal-delta H2D + packed
    residual D2H) restores a chained multi-batch stream bit-exactly,
    including the ragged tail that rides the raw transport."""
    p = synth_engine_params(37)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(37, p)
    frames = synth_frames(7, 32, 48, seed=21)  # 3 full batches + tail of 1
    want = O.forward_blu(frames, p)
    got = eng.restore_stream(frames, 37, transport="duplex")
    assert (got == want).all()
    assert eng._last_impl.endswith("+duplex") or eng._last_impl == "int"
    # a second stream reuses the cached transport (carry chains across)
    got2 = eng.restore_stream(frames, 37, transport="duplex")
    assert (got2 == want).all()


def test_run_sequence_duplex_transport(tmp_path, clip):
    ori_p, anc_p, ori, anchor = clip
    p = synth_engine_params(37)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(37, p)
    rec = eng.run_sequence(
        "seq", ori_p, anc_p, 48, 64, 37, frames=3, transport="duplex",
        recon_path=str(tmp_path / "rec.yuv"),
    )
    got = yuv.read_y(str(tmp_path / "rec.yuv"), 48, 64, 3)
    assert (got == O.forward_blu(anchor, p)).all()
    assert rec.time_us > 0


def test_duplex_failure_evicts_transport(tmp_path, monkeypatch):
    """A mid-stream duplex failure raises and must NOT leave the desynced
    transport cached: the producer can run send() calls past a receive()
    that raised, so reusing the transport would decode silently wrong
    frames (res = stale _res + cumsum). The engine evicts on failure; the
    next duplex stream starts from a fresh transport and stays bit-exact."""
    p = synth_engine_params(37)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(37, p)
    frames = synth_frames(6, 32, 48, seed=33)
    want = O.forward_blu(frames, p)

    from qcnn_gpu.engine.packed import DuplexTransport

    calls = {"n": 0}
    orig = DuplexTransport.receive

    def flaky(self, x, item):
        calls["n"] += 1
        if calls["n"] == 2:  # fail mid-stream, after state advanced
            raise RuntimeError("injected link failure")
        return orig(self, x, item)

    monkeypatch.setattr(DuplexTransport, "receive", flaky)
    key = (37, (32, 48), 2)
    with pytest.raises(RuntimeError, match="injected link failure"):
        eng.restore_stream(frames, 37, transport="duplex")
    assert key not in eng._duplex  # desynced transport evicted
    monkeypatch.setattr(DuplexTransport, "receive", orig)
    got2 = eng.restore_stream(frames, 37, transport="duplex")
    assert (got2 == want).all()  # fresh transport, bit-exact again


def test_duplex_send_snapshots_prev_frame(tmp_path):
    """DuplexTransport.send must copy the last frame: a caller reusing its
    frame buffer between batches must not corrupt the host reference."""
    from qcnn_gpu.engine.packed import make_duplex_restore
    from qcnn_gpu.models.qvrcnn import make_forward

    p = synth_engine_params(37)
    run = make_forward(p, impl="int")
    tr = make_duplex_restore(run)
    buf = synth_frames(2, 32, 48, seed=40)  # reused buffer
    want0 = O.forward_blu(buf, p)
    rec0 = tr.receive(buf, tr.send(buf))
    assert (rec0 == want0).all()
    buf[:] = 0  # caller stomps its buffer before the next batch: with a
    # view-held _prev this would desync the host reference frame from the
    # device anchor carry and corrupt the next decode
    nxt = synth_frames(2, 32, 48, seed=41)
    item = tr.send(nxt.copy())
    nxt_rec = tr.receive(nxt, item)
    assert (nxt_rec == O.forward_blu(nxt, p)).all()


def test_cli_run_2d_mesh(tmp_path, clip):
    """CLI --mesh dpxspxsw drives the 2-D halo-sharded engine end-to-end
    on disk artifacts, bit-exact vs the oracle."""
    import jax

    from qcnn_gpu import cli

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    ori_p, anc_p, _, anchor = clip
    p = synth_engine_params(37)
    vect = str(tmp_path / "m.vectc")
    model_files.write_static_qfp_vect_c(vect, p)
    rc = cli.main(
        [
            "run", "--ori", ori_p, "--anchor", anc_p, "--height", "48",
            "--width", "64", "--frames", "2", "--model", vect, "--qp", "37",
            "--impl", "int", "--mesh", "1x2x2", "--out-dir", str(tmp_path),
            "--recon", str(tmp_path / "r2d.yuv"),
        ]
    )
    assert rc == 0
    recon = yuv.read_y(str(tmp_path / "r2d.yuv"), 48, 64, 2)
    assert (recon == O.forward_blu(anchor[:2], p)).all()


def test_transport_auto_picks_and_restores(tmp_path, clip):
    """transport='auto' (VERDICT r4 #5): the engine probes the link vs the
    device rate, records a decision per (qp, geometry, batch), and the
    stream stays bit-exact regardless of which wire it picked."""
    ori_p, anc_p, ori, anchor = clip
    p = synth_engine_params(37)
    model_p = str(tmp_path / "m.data")
    model_files.write_static_qfp_vect_c(model_p, p)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.load_model(37, model_p)
    got = eng.restore_stream(anchor, 37, transport="auto")
    assert (got == O.forward_blu(anchor, p)).all()
    (dec,) = list(eng.transport_decisions.values())
    assert dec["transport"] in ("raw", "duplex")
    assert dec["link_mbps"] is None or dec["link_mbps"] > 0
    # decision is cached per key: a second stream must not re-probe
    n0 = len(eng.transport_decisions)
    got2 = eng.restore_stream(anchor, 37, transport="auto")
    assert (got2 == got).all() and len(eng.transport_decisions) == n0


def test_transport_auto_duplex_when_link_bound(tmp_path, clip, monkeypatch):
    """A link measured slower than the device rate must select the duplex
    wire (and the stream still matches the oracle through it)."""
    ori_p, anc_p, ori, anchor = clip
    p = synth_engine_params(37)
    model_p = str(tmp_path / "m.data")
    model_files.write_static_qfp_vect_c(model_p, p)
    eng = Engine(impl="int", out_dir=str(tmp_path), batch_frames=2)
    eng.load_model(37, model_p)
    key = (37, anchor.shape[-2:], 2)
    eng.transport_decisions[key] = {
        "transport": "duplex", "link_mbps": 1.0, "link_fps": 0.5,
        "device_fps": 100.0,
    }
    got = eng.restore_stream(anchor[:2], 37, transport="auto")
    assert (got == O.forward_blu(anchor[:2], p)).all()
    assert eng._last_impl.endswith("+duplex")


def _broken_program(monkeypatch):
    """Make every restoration program the Engine builds fail when called."""
    from qcnn_gpu.engine import runner as runner_mod

    def broken_forward(p, impl="auto"):
        def run(frames):
            raise RuntimeError("injected device failure")

        run.impl = "int"
        return run

    monkeypatch.setattr(runner_mod, "make_forward", broken_forward)


@pytest.mark.parametrize("call", ["restore", "restore_stream"])
def test_failing_program_raises(tmp_path, monkeypatch, call):
    """A program that fails raises out of the Engine: nothing demotes it to
    another implementation or to host tiling."""
    _broken_program(monkeypatch)
    eng = Engine(out_dir=str(tmp_path), batch_frames=2)
    eng.set_model(37, synth_engine_params(37))
    frames = synth_frames(3, 24, 40, seed=1)
    with pytest.raises(RuntimeError, match="injected device failure"):
        getattr(eng, call)(frames, 37)


def test_set_model_drops_old_program(tmp_path):
    """Swapping a QP's model rebuilds its program from the new weights."""
    eng = Engine(out_dir=str(tmp_path), batch_frames=2)
    frames = synth_frames(2, 24, 40, seed=2)
    for qp_table in (37, 22):
        p = synth_engine_params(qp_table)
        eng.set_model(30, p)
        assert (eng.restore(frames, 30) == O.forward_blu(frames, p)).all()
