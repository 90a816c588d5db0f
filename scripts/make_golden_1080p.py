"""1080p golden closure (VERDICT r4 #3): golden content at the geometry
the perf headline is measured at.

Evaluates the COMMITTED per-QP INT8 engine models (assets/golden/
model_q{qp}.data — trained by scripts/make_golden.py on the 240p hopper
clip) over a native 1920x1080 composite pan (data/golden.fullhd_clip) with
per-QP JPEG anchors, and records held-out PSNR before/after as goldens.
Generalization is the point: the models never saw this content or
geometry; the committed goldens then pin the engine's behavior at the
geometry where the band-split/atlas/spill kernel classes actually engage
(tests/test_golden_psnr.py routes the regression through BOTH the XLA
engine and the tuned pallas3 kernel).

Run on CPU (deterministic):
    env JAX_PLATFORM_NAME=cpu python scripts/make_golden_1080p.py
"""

import json
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platform_name", "cpu")

    from qcnn_gpu.data import yuv
    from qcnn_gpu.data.golden import GOLDEN_DIR, QP_QUALITY, fullhd_clip, jpeg_anchor
    from qcnn_gpu.data.model_files import read_static_qfp_vect_c
    from qcnn_gpu.engine.tiled import restore_tiled
    from qcnn_gpu.models.qvrcnn import make_forward

    clean = fullhd_clip()
    goldens = {}
    for qp in QP_QUALITY:
        anchor = jpeg_anchor(clean, QP_QUALITY[qp])
        before = yuv.psnr(anchor, clean)
        p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
        # tiled 540x960 == whole-frame (tested); bounds the CPU's memory
        rec = restore_tiled(make_forward(p, impl="auto"), anchor, 540, 960)
        after = yuv.psnr(rec, clean)
        goldens[str(qp)] = {"before": round(before, 6), "after": round(after, 6)}
        print(f"QP{qp}: {before:.3f} -> {after:.3f} dB ({after - before:+.3f})",
              flush=True)
        with open(os.path.join(GOLDEN_DIR, f"psnr_static_fullhd_{qp}.data"),
                  "wb") as fp:
            fp.write(struct.pack("<2d", before, after))
    with open(os.path.join(GOLDEN_DIR, "psnr_golden_1080p.json"), "w") as fp:
        json.dump(
            {
                "clip": "composite mirror-tiled pan 1920x1080",
                "frames_eval": clean.shape[0],
                "qp_quality": QP_QUALITY,
                "models": "model_q{qp}.data (240p-hopper-trained, held out)",
                "goldens": goldens,
            },
            fp,
            indent=1,
        )
    print(json.dumps(goldens))


if __name__ == "__main__":
    main()
