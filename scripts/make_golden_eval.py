"""Second-content / second-geometry golden PSNRs (VERDICT r2 item 8).

The hopper goldens (scripts/make_golden.py) cover one photograph at
416x240. This script records HELD-OUT goldens for the multi-region
composite clip at 832x480 (qcnn_gpu/data/golden.py composite_clip):
content the committed models never trained on, at a geometry that
exercises the kernel's atlas spill classes and the host tiling path a
240p clip never reaches. The committed per-QP engine models are reused
as-is — the point is a regression TRIPWIRE over different code paths,
not a quality claim (generalization gains on unseen content are small).

PSNR is computed from the integer engine's output, which is bit-exact
across platforms, so goldens generated on CPU hold on the GPU.

    env JAX_PLATFORMS=cpu python scripts/make_golden_eval.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qcnn_gpu.data import yuv  # noqa: E402
from qcnn_gpu.data.golden import (  # noqa: E402
    GOLDEN_DIR,
    H2,
    N_EVAL2,
    QP_QUALITY,
    W2,
    composite_clip,
    jpeg_anchor,
)
from qcnn_gpu.data.model_files import read_static_qfp_vect_c  # noqa: E402
from qcnn_gpu.models.qvrcnn import make_forward  # noqa: E402

EVAL_PHASE = 0.5  # no overlap with any training pan


def main():
    clean = composite_clip(N_EVAL2, phase=EVAL_PHASE)
    goldens = {}
    for qp, quality in QP_QUALITY.items():
        anchor = jpeg_anchor(clean, quality)
        before = yuv.psnr(anchor, clean)
        p = read_static_qfp_vect_c(os.path.join(GOLDEN_DIR, f"model_q{qp}.data"))
        rec = np.asarray(make_forward(p, impl="int")(anchor))
        after = yuv.psnr(rec, clean)
        goldens[qp] = {"before": round(before, 6), "after": round(after, 6)}
        print(f"QP{qp} (jpeg q{quality}): {before:.3f} -> {after:.3f} dB "
              f"({after - before:+.3f})", flush=True)
    out = os.path.join(GOLDEN_DIR, "psnr_golden_composite.json")
    with open(out, "w") as fp:
        json.dump(
            {
                "clip": "DEM+MRI+photo composite pan",
                "geometry": [H2, W2],
                "frames_eval": N_EVAL2,
                "phase": EVAL_PHASE,
                "qp_quality": QP_QUALITY,
                "goldens": goldens,
            },
            fp,
            indent=1,
        )
    print("wrote", out)


if __name__ == "__main__":
    main()
