"""Wide-CNN (EDSR-scale) single-GPU benchmark — BASELINE config 5.

Measures the INT8 wide restoration net (models/wide.py) on real hardware
at its production scale (256 channels x 10 body convs, ~5.3M int8
weights, ~2.8 TMAC per 832x480 frame): the model family the framework's
tensor parallelism exists for. Exactness is certified against the XLA
graph run at a reduced width first (the NumPy oracle at full scale needs
minutes), then the full-scale net is timed.

    python scripts/bench_wide.py [channels] [blocks] [h] [w]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(channels=256, blocks=10, h=480, w=832):
    channels, blocks, h, w = int(channels), int(blocks), int(h), int(w)
    import jax

    from qcnn_gpu.compile_cache import enable_compile_cache
    from qcnn_gpu.models import wide as W
    from qcnn_gpu.testing import synth_frames

    enable_compile_cache()
    # correctness first: a reduced-width twin vs the NumPy oracle
    p_small = W.synth_wide_params(channels=32, blocks=3, seed=5)
    xs = synth_frames(1, 48, 64, seed=6)
    exact = bool(
        (np.asarray(W.make_wide_forward(p_small)(xs)) == W.forward_wide(xs, p_small)).all()
    )

    p = W.synth_wide_params(channels=channels, blocks=blocks, seed=7)
    run = W.make_wide_forward(p)
    batch = max(1, int(60e6 / (h * w)))
    x = jax.device_put(synth_frames(batch, h, w, seed=8))
    out = run(x)
    out.block_until_ready()  # compile outside the timed region
    n = 8
    t0 = time.perf_counter()
    for _ in range(n):
        out = run(x)
    out.block_until_ready()
    dt = time.perf_counter() - t0
    ms = 1000 * dt / (n * batch)
    macs = h * w * 9 * (channels + channels * channels * blocks + channels)
    print(
        json.dumps(
            {
                "model": f"wide c{channels} b{blocks}",
                "geometry": f"{h}x{w}",
                "batch": batch,
                "ms_per_frame": round(ms, 3),
                "fps": round(1000.0 / ms, 1),
                "tmac_per_frame": round(macs / 1e12, 3),
                "int8_tops": round(macs * 2 / (ms / 1000) / 1e12, 1),
                "small_twin_exact_vs_oracle": exact,
                "backend": jax.default_backend(),
            }
        )
    )


if __name__ == "__main__":
    main(*sys.argv[1:])
