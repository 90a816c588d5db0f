"""Single-layer conv microbenchmark — the test_layer analog
(kernel.cu:28-73: one cuDNN conv, QueryPerformanceCounter around it).

    python scripts/bench_layer.py [--layer C2_2] [--height 720 --width 1280]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layer", default="C1", choices=["C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4"])
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from qcnn_gpu.models.topology import LAYER_NAMES, QVRCNN_LAYERS
    from qcnn_gpu.testing import synth_engine_params

    idx = LAYER_NAMES.index(args.layer)
    layer = QVRCNN_LAYERS[idx]
    p = synth_engine_params(37)
    w = jnp.asarray(p.weights[idx], jnp.bfloat16)
    b = jnp.asarray(p.biases[idx], jnp.int32)
    rng = np.random.default_rng(0)
    x = jax.device_put(
        jnp.asarray(
            rng.integers(0, 128, (args.batch, args.height, args.width, layer.in_ch)),
            jnp.bfloat16,
        )
    )

    @jax.jit
    def conv(x):
        u = lax.conv_general_dilated(
            x, w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32,
        )
        return u.astype(jnp.int32) + b

    o = conv(x)
    jax.block_until_ready(o)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        o = conv(x)
    jax.block_until_ready(o)
    dt = (time.perf_counter() - t0) / (args.iters * args.batch)
    macs = layer.ksize**2 * layer.in_ch * layer.out_ch * args.height * args.width
    print(
        f"{args.layer} {layer.ksize}x{layer.ksize} {layer.in_ch}->{layer.out_ch} "
        f"@{args.width}x{args.height}: {dt*1e6:.0f} us/frame "
        f"({2*macs/dt/1e12:.1f} TFLOP/s)"
    )


if __name__ == "__main__":
    main()
