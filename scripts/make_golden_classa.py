"""Class-A golden closure (round 5): 2560x1600 — the largest geometry the
reference's psnr_static goldens span (class A, 18-sequence JCT-VC set).

Same construction as make_golden_1080p.py: the committed 240p-trained
per-QP INT8 models evaluated held-out over a native 2560x1600 composite
pan with per-QP JPEG anchors (committed anchor BYTES), goldens pinned by
tests/test_golden_psnr.py through the host-tiled engine path.

Run on CPU:  env JAX_PLATFORM_NAME=cpu python scripts/make_golden_classa.py
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
    from qcnn_gpu.data.golden import (
        GOLDEN_DIR,
        QP_QUALITY,
        classa_clip,
        jpeg_anchor,
        write_anchor_bytes,
    )
    from qcnn_gpu.data.model_files import read_static_qfp_vect_c
    from qcnn_gpu.engine.tiled import restore_tiled
    from qcnn_gpu.models.qvrcnn import make_forward

    clean = classa_clip()
    goldens = {}
    for qp in QP_QUALITY:
        anchor = jpeg_anchor(clean, QP_QUALITY[qp])
        write_anchor_bytes("classa_eval", clean, QP_QUALITY[qp])
        before = yuv.psnr(anchor, clean)
        p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
        rec = restore_tiled(make_forward(p, impl="auto"), anchor, 540, 960)
        after = yuv.psnr(rec, clean)
        goldens[str(qp)] = {"before": round(before, 6), "after": round(after, 6)}
        print(f"QP{qp}: {before:.3f} -> {after:.3f} dB ({after - before:+.3f})",
              flush=True)
        with open(os.path.join(GOLDEN_DIR, f"psnr_static_classa_{qp}.data"),
                  "wb") as fp:
            fp.write(struct.pack("<2d", before, after))
    with open(os.path.join(GOLDEN_DIR, "psnr_golden_classa.json"), "w") as fp:
        json.dump(
            {
                "clip": "composite mirror-tiled pan 2560x1600 (class A)",
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
