"""Channel-sharded (tensor-parallel) conv layers — the TP analog.

SURVEY.md §2.4 P6: the reference has no model parallelism; this build
introduces optional channel sharding for wide-CNN stretch configs (an
EDSR-scale restoration net has 256+ channels where sharding weights
matters; QVRCNN's 64 channels fit one chip trivially, so this component is
exercised at demonstration scale and kept exactly output-equivalent).

Scheme (the standard pair of shardings for back-to-back convs):
  * layer L: OUTPUT channels sharded over the mesh's `tp` axis — each
    device holds w[..., :, shard] and computes its slice of the feature
    map; no communication.
  * layer L+1: INPUT channels sharded — each device contracts its local
    channel slice and the partial sums combine with ONE psum.

For the float model this wraps residual_float with a 2-conv TP pattern;
`tp_pair_forward` is the reusable primitive. Integer semantics note: a
psum of int32 partials is exact, so the same scheme applies to the INT8
engine unchanged (the requant epilogue runs after the psum).
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

_DN = ("NHWC", "HWIO", "NHWC")


def _conv(x, w):
    return lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=_DN)


def tp_pair_forward(x, w_a, b_a, w_b, b_b, axis_name: str):
    """Two chained convs with channel sharding over `axis_name`.

    Call under shard_map with w_a sharded on its OUTPUT-channel dim and
    w_b sharded on its INPUT-channel dim; x and the result replicated.
    The hidden activation never materializes unsharded; one psum combines
    the second conv's partial sums. Exactly equals the unsharded pair.
    """
    h = jnp.maximum(_conv(x, w_a) + b_a, 0.0)  # local out-channel slice
    partial_out = _conv(h, w_b)  # partial sum over local in-channels
    out = lax.psum(partial_out, axis_name)
    return out + b_b


def make_tp_conv_pair(mesh: Mesh, axis: str = "sp"):
    """Jitted fn(x, w_a, b_a, w_b, b_b) computing the sharded pair over
    mesh axis `axis` (weights passed unsharded; shard_map splits them)."""

    f = jax.shard_map(
        partial(tp_pair_forward, axis_name=axis),
        mesh=mesh,
        in_specs=(
            P(),  # x replicated
            P(None, None, None, axis),  # w_a out-channels sharded
            P(axis),  # b_a sharded
            P(None, None, axis, None),  # w_b in-channels sharded
            P(),  # b_b replicated
        ),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(f)


def make_tp_int8_forward(p, mesh: Mesh, axis: str = "sp"):
    """Channel-sharded INT8 QVRCNN — TP integrated with the real engine.

    The merged 4-stage graph as two Megatron pairs over mesh axis `axis`:

      S1 (1->64)  column-parallel: output channels + their per-channel
                  requant vectors sharded; no communication.
      S2 (64->48) row-parallel: input channels sharded; ONE int32 psum
                  combines the partial accumulators, THEN bias + BLU
                  requant run on the exact full sum — integer psum is
                  exact, so the epilogue sees bit-identical accumulators.
      S3 (48->48) column-parallel again; S4 (48->1) row-parallel with the
                  final-residual requant after its psum.

    Bit-exact vs the unsharded engine/oracle (tested on the CPU mesh).
    Requires 64 % tp == 0 and 48 % tp == 0 (tp in {1,2,4,8,16}).

    Returns fn(uint8 [N,H,W]) -> uint8 [N,H,W]. SURVEY §2.4 P6.
    """
    from qcnn_gpu.models.qvrcnn import MergedParams, _conv_int
    from qcnn_gpu.ops.requant import apply_residual_u8, final_residual_i32

    mp = MergedParams.from_engine(p)
    tp = mesh.shape[axis]
    assert 64 % tp == 0 and 48 % tp == 0, f"tp={tp} must divide 64 and 48"

    def requant(u, blu_q, mul, bias_pre, shift):
        mid = jnp.right_shift((u + bias_pre) * mul, shift)
        return jnp.where(u > blu_q, 127, jnp.where(u < 0, 0, mid))

    def block(x, w1, b1, q1, w2, b2, q2, w3, b3, q3, w4, b4):
        v1 = requant(_conv_int(x, w1, b1), *q1)  # [.., 64/tp] local
        u2 = lax.psum(_conv_int(v1, w2, jnp.zeros((), jnp.int32)), axis) + b2
        v2 = requant(u2, *q2)  # [.., 48] replicated
        v3 = requant(_conv_int(v2, w3, b3), *q3)  # [.., 48/tp] local
        u4 = lax.psum(_conv_int(v3, w4, jnp.zeros((), jnp.int32)), axis) + b4
        return final_residual_i32(u4, mp.mul4, mp.shift4)[..., 0]

    shard_c = P(axis)
    f = jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(
            P(),  # x replicated
            P(None, None, None, axis), shard_c, (shard_c,) * 4,  # S1 col
            P(None, None, axis, None), P(), (P(),) * 4,  # S2 row (psum)
            P(None, None, None, axis), shard_c, (shard_c,) * 4,  # S3 col
            P(None, None, axis, None), P(),  # S4 row (psum)
        ),
        out_specs=P(),
        check_vma=False,
    )
    q = lambda i: (mp.blu_q[i], mp.mul[i], mp.bias_pre[i], mp.shift[i])
    args = (
        mp.w_i8[0], mp.b_i32[0], q(0),
        mp.w_i8[1], mp.b_i32[1], q(1),
        mp.w_i8[2], mp.b_i32[2], q(2),
        mp.w_i8[3], mp.b_i32[3],
    )

    @jax.jit
    def run(x_uint8):
        x = x_uint8[..., None].astype(jnp.int32) - 128
        res = f(x, *args)
        return apply_residual_u8(x_uint8, res)

    run.mesh = mesh
    run.impl = f"tp{tp}-int8"
    return run


def make_tp_wide_forward(p, mesh: Mesh, axis: str = "sp"):
    """Channel-sharded INT8 wide net (models/wide.py) — TP at the scale it
    exists for (EDSR-class, 256+ channels; BASELINE config 5).

    Layers alternate Megatron column/row parallelism:
      * head (1->C) column-parallel: each device computes C/tp output
        channels; its BLU requant is per-layer scalar, so the local slice
        requants independently — no communication;
      * body convs alternate row-parallel (input channels sharded, ONE
        int32 psum rebuilds the exact accumulator before the requant) and
        column-parallel (no comms);
      * tail (C->1) row-parallel with the final residual requant after
        its psum.

    With this pairing a body of B blocks costs ceil((B+1)/2) psums total.
    Bit-exact vs forward_wide (integer psum is exact; every requant sees
    the same accumulator as the unsharded graph). Requires channels % tp
    == 0. Returns fn(uint8 [N,H,W]) -> uint8 [N,H,W].
    """
    from qcnn_gpu.models.qvrcnn import _conv_int
    from qcnn_gpu.ops.requant import (
        apply_residual_u8,
        blu_requant_i32,
        final_residual_i32,
    )

    tp = mesh.shape[axis]
    c = p.channels
    assert c % tp == 0, f"tp={tp} must divide channels={c}"
    n_layers = len(p.weights)

    # The sharding chain admits no choice: a column-parallel layer leaves
    # its output channel-sharded, which is exactly a row-parallel layer's
    # input contract, whose psum leaves the output replicated — the
    # column-parallel input contract. The head consumes the replicated
    # frame, so layer i is 'col' iff i is even. The tail (cout=1) is
    # row-parallel when its index is odd; at an even index its input is
    # replicated and 1 output channel cannot be column-sharded, so it runs
    # replicated ('rep': full weights, no communication).
    modes = ["col" if i % 2 == 0 else "row" for i in range(n_layers - 1)]
    modes.append("row" if (n_layers - 1) % 2 == 1 else "rep")

    def block(x, *flat):
        ws = flat[:n_layers]
        bs = flat[n_layers:]
        v = x
        for i in range(n_layers):
            if modes[i] == "row":
                u = lax.psum(
                    _conv_int(v, ws[i], jnp.zeros((), jnp.int32)), axis
                ) + bs[i]
            else:  # col / rep: purely local
                u = _conv_int(v, ws[i], bs[i])
            if i < n_layers - 1:
                v = blu_requant_i32(u, p.blu_q[i], p.mul[i], p.shift[i])
        return final_residual_i32(u, p.mul_last, p.shift_last)[..., 0]

    w_specs, b_specs = [], []
    for m in modes:
        if m == "col":
            w_specs.append(P(None, None, None, axis))
            b_specs.append(P(axis))
        elif m == "row":
            w_specs.append(P(None, None, axis, None))
            b_specs.append(P())
        else:  # rep
            w_specs.append(P())
            b_specs.append(P())

    f = jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(), *w_specs, *b_specs),
        out_specs=P(),
        check_vma=False,
    )
    ws = [jnp.asarray(w) for w in p.weights]
    bs = [jnp.asarray(b, jnp.int32) for b in p.biases]

    @jax.jit
    def run(x_uint8):
        x = x_uint8[..., None].astype(jnp.int32) - 128
        res = f(x, *ws, *bs)
        return apply_residual_u8(x_uint8, res)

    run.mesh = mesh
    run.impl = f"tp{tp}-wide-int8"
    return run
