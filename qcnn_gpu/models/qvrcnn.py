"""QVRCNN INT8 inference as a single XLA program.

The whole 9-node graph (preprocess, 6 convs merged into 4 stages, 2
concats, residual add) is ONE jitted function per (params, geometry).
On a GPU, XLA hands each stage's conv to cuDNN and fuses the integer
requant epilogue around it. That is the reference's own design (one
cudnnConvolutionForward per stage plus a requant/BLU kernel,
mat.cu:262-314) without its cudaDeviceSynchronize between stages.

Two conv forms, both bit-exact against models/oracle.py:

  * int:  int8 operands and int32 accumulation, as the reference's INT8x4
          config. cuDNN returns the accumulator as f32, exact below 2^24;
          `int_conv_groups` splits a conv whose sums could reach 2^24
          into input-channel slices summed in int32, so every model is
          exact. Activations travel between stages as int8, which is
          exact because BLU outputs lie in [0, 127].
  * bf16: int8 values are exact in bfloat16, int8 x int8 products are
          exact in f32, and f32 accumulation of integers is exact while
          every partial sum stays below 2^24. `exactness_bounds`
          certifies that per layer at load time (sum |w| * in_max + |b|
          < 2^24 per output channel). A model that fails the certificate
          runs through `int`.

`resolve_impl` picks the form: int, measured the faster on the GPU.

Reference behavior mirrored: forward_blu (qvrcnn.cu:168-242) with the
epilogue contract of SURVEY.md §5.1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from qcnn_gpu.models.oracle import EngineParams
from qcnn_gpu.models.topology import QVRCNN_LAYERS
from qcnn_gpu.ops.requant import (
    apply_residual_u8,
    blu_requant_i32,
    final_residual_i32,
)

ConvImpl = Literal["bf16", "int", "auto"]

_DIM_NUMBERS = ("NHWC", "HWIO", "NHWC")
_EXACT_F32_LIMIT = 1 << 24


def exactness_bounds(p: EngineParams) -> List[int]:
    """Per-layer worst-case |accumulator| bound: max over output channels of
    sum(|w|) * in_amax + |b|, where in_amax is 128 for C1 (input is x-128)
    and 127 for BLU-fed layers. If every bound < 2^24, f32 accumulation of
    the integer conv is exact for ANY input, so the bf16 path is
    bit-exact."""
    bounds = []
    for i, layer in enumerate(QVRCNN_LAYERS):
        in_amax = 128 if layer.input == "input" else 127
        w_l1 = np.abs(p.weights[i].astype(np.int64)).sum(axis=(0, 1, 2))
        bound = int(np.max(w_l1 * in_amax + np.abs(p.biases[i].astype(np.int64))))
        bounds.append(bound)
    return bounds


def certify_exact_bf16(p: EngineParams) -> bool:
    return all(b < _EXACT_F32_LIMIT for b in exactness_bounds(p))


def int_conv_groups(w: np.ndarray, in_amax: int) -> int:
    """Fewest equal input-channel slices of int8 conv weights w [kh, kw,
    cin, cout] whose worst-case partial sums (sum |w| * in_amax over the
    slice, per output channel) all stay below 2^24. The int path's cuDNN
    conv returns its int32 accumulator as f32 (cuDNN has no int8 conv with
    int32 output), which is exact below 2^24; wider sums are split into
    such slices and added in int32. 1 for every model that passes
    `certify_exact_bf16`."""
    kh, kw, cin, cout = w.shape
    a = np.abs(np.asarray(w, np.int64))
    for g in range(1, cin + 1):
        if cin % g:
            continue
        parts = a.reshape(kh, kw, g, cin // g, cout).sum(axis=(0, 1, 3))
        if int(parts.max()) * in_amax < _EXACT_F32_LIMIT:
            return g
    raise ValueError(f"conv {w.shape} cannot be split into exact f32 slices")


def _normalized_table(p: EngineParams):
    """Per-layer (mul, shift) with common powers of two stripped (an exact
    identity — ops/requant.normalize_mul_shift), then range-checked so the
    engine's int32 requant can never wrap: BLU layers against their
    clamped product, the final layer against its worst-case accumulator
    bound. Solver outputs for near-degenerate layers (observed in INT4
    solves: mul=2^25/shift=27) land back in the reference envelope."""
    from qcnn_gpu.ops.requant import (
        check_blu_requant_i32_safe,
        normalize_mul_shift,
    )

    muls, shifts = [], []
    for i in range(6):
        if np.ndim(p.mul[i]) or np.ndim(p.shift[i]):
            # per-channel rows (LayerQuantVec tables): normalize and
            # range-check every channel independently
            mv, sv = np.broadcast_arrays(
                np.asarray(p.mul[i], np.int64), np.asarray(p.shift[i], np.int64)
            )
            bv = np.broadcast_to(np.asarray(p.blu_q[i], np.int64), mv.shape)
            pairs = [normalize_mul_shift(m, s) for m, s in zip(mv, sv)]
            m = np.asarray([q[0] for q in pairs], np.int64)
            s = np.asarray([q[1] for q in pairs], np.int64)
            if i < 5:
                for c in range(len(m)):
                    check_blu_requant_i32_safe(
                        bv[c], m[c], s[c], name=f"layer {i} ch {c}"
                    )
        else:
            m, s = normalize_mul_shift(p.mul[i], p.shift[i])
            if i < 5:
                check_blu_requant_i32_safe(p.blu_q[i], m, s, name=f"layer {i}")
        muls.append(m)
        shifts.append(s)
    bound5 = exactness_bounds(p)[5]
    if bound5 * muls[5] + (1 << (shifts[5] - 1)) >= 1 << 31:
        raise ValueError(
            f"final requant (mul={muls[5]}, shift={shifts[5]}) can wrap "
            f"int32 at accumulator bound {bound5}; re-solve with a smaller shift"
        )
    return tuple(muls), tuple(shifts)


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Device-ready parameters. Weights/biases as jnp arrays; quant scalars
    stay Python ints (compile-time constants folded into the XLA program,
    like the reference folds them into kernel launches)."""

    weights_bf16: Tuple[jnp.ndarray, ...]
    weights_i8: Tuple[jnp.ndarray, ...]
    biases_i32: Tuple[jnp.ndarray, ...]
    blu_q: Tuple[int, ...]
    mul: Tuple[int, ...]
    shift: Tuple[int, ...]
    exact_bf16: bool
    int_groups: Tuple[int, ...]  # int_conv_groups per layer

    @classmethod
    def from_engine(cls, p: EngineParams) -> "ModelParams":
        p.validate()
        mul, shift = _normalized_table(p)
        return cls(
            weights_bf16=tuple(
                jnp.asarray(w, dtype=jnp.bfloat16) for w in p.weights
            ),
            weights_i8=tuple(jnp.asarray(w, dtype=jnp.int8) for w in p.weights),
            biases_i32=tuple(jnp.asarray(b, dtype=jnp.int32) for b in p.biases),
            blu_q=tuple(
                np.asarray(v, np.int64) if np.ndim(v) else int(v)
                for v in p.blu_q
            ),
            mul=mul,
            shift=shift,
            exact_bf16=certify_exact_bf16(p),
            int_groups=tuple(
                int_conv_groups(w, 128 if i == 0 else 127)
                for i, w in enumerate(p.weights)
            ),
        )


@dataclasses.dataclass(frozen=True)
class MergedParams:
    """Branch-merged parameters: each concat stage's two convs fused into
    ONE conv by zero-padding the smaller kernel to the larger size and
    stacking output channels in concat order. Bit-identical (the padded
    taps contribute exact zeros): the 16/32-channel branch tensors and
    the concats disappear, every intermediate is 48 or 64 channels, and
    4 convs replace 6. The zero taps cost issued work: S2 issues 76.8k
    MACs/px against 44.0k useful.

      S1: 5x5x 1->64  (C1)
      S2: 5x5x64->48  (C2_1 3x3 zero-padded to 5x5 | C2_2), concat order
          matching ConcatLayer (cnn.cu:375-394)
      S3: 3x3x48->48  (C3_1 | C3_2 1x1 zero-padded to 3x3)
      S4: 3x3x48->1   (C4)

    Requant scalars become per-output-channel vectors (the engine's
    per-branch mul/shift/blu, applied channel-wise)."""

    w_bf16: Tuple[jnp.ndarray, ...]
    w_i8: Tuple[jnp.ndarray, ...]
    b_i32: Tuple[jnp.ndarray, ...]
    blu_q: Tuple[jnp.ndarray, ...]  # per-channel i32, stages 1..3
    mul: Tuple[jnp.ndarray, ...]
    bias_pre: Tuple[jnp.ndarray, ...]  # (1<<(shift-1))//mul, precomputed
    shift: Tuple[jnp.ndarray, ...]
    mul4: int
    shift4: int
    exact_bf16: bool
    int_groups: Tuple[int, ...]  # int_conv_groups per stage

    @classmethod
    def from_engine(cls, p: EngineParams) -> "MergedParams":
        p.validate()

        def pad_kernel(w: np.ndarray, k_to: int) -> np.ndarray:
            k = w.shape[0]
            r = (k_to - k) // 2
            return np.pad(w, ((r, r), (r, r), (0, 0), (0, 0)))

        w = [np.asarray(x, dtype=np.int8) for x in p.weights]
        b = [np.asarray(x, dtype=np.int32) for x in p.biases]
        ws = [
            w[0],
            np.concatenate([pad_kernel(w[1], 5), w[2]], axis=3),
            np.concatenate([w[3], pad_kernel(w[4], 3)], axis=3),
            w[5],
        ]
        bs = [b[0], np.concatenate([b[1], b[2]]), np.concatenate([b[3], b[4]]), b[5]]

        n_mul, n_shift = _normalized_table(p)

        def vec(idx_pairs):
            """Per-channel requant vectors for a merged stage. Scalar rows
            broadcast to their channel count; per-channel rows
            (LayerQuantVec tables) pass through as-is."""
            blu, mul, bias, shift = [], [], [], []
            for idx, nch in idx_pairs:
                b = np.broadcast_to(np.asarray(p.blu_q[idx], np.int64), (nch,))
                m = np.broadcast_to(np.asarray(n_mul[idx], np.int64), (nch,))
                s = np.broadcast_to(np.asarray(n_shift[idx], np.int64), (nch,))
                blu += list(b)
                mul += list(m)
                bias += list((1 << (s - 1)) // m)
                shift += list(s)
            return tuple(
                jnp.asarray(v, dtype=jnp.int32) for v in (blu, mul, bias, shift)
            )

        v1 = vec([(0, 64)])
        v2 = vec([(1, 32), (2, 16)])
        v3 = vec([(3, 16), (4, 32)])
        return cls(
            w_bf16=tuple(jnp.asarray(x, dtype=jnp.bfloat16) for x in ws),
            w_i8=tuple(jnp.asarray(x, dtype=jnp.int8) for x in ws),
            b_i32=tuple(jnp.asarray(x, dtype=jnp.int32) for x in bs),
            blu_q=(v1[0], v2[0], v3[0]),
            mul=(v1[1], v2[1], v3[1]),
            bias_pre=(v1[2], v2[2], v3[2]),
            shift=(v1[3], v2[3], v3[3]),
            mul4=int(n_mul[5]),
            shift4=int(n_shift[5]),
            exact_bf16=certify_exact_bf16(p),
            int_groups=tuple(
                int_conv_groups(w, 128 if i == 0 else 127)
                for i, w in enumerate(ws)
            ),
        )


def residual_blu_merged(
    x_ppro: jnp.ndarray,
    mp: "MergedParams",
    impl: str = "int",
    row_valid: Optional[jnp.ndarray] = None,
    col_valid: Optional[jnp.ndarray] = None,
    carry=None,
) -> jnp.ndarray:
    """Merged-stage core: 4 convs, per-channel vector requant. Bit-equal to
    residual_blu (tested); this is the production path.

    row_valid [H] / col_valid [W] mark rows/cols INSIDE the frame — the
    2-D generalization used by (sp, sw) halo sharding: halo rows AND halo
    cols beyond the true frame edge must read as per-layer zero padding
    (see residual_blu docstring for why every stage masks).

    Inter-stage activations are CARRIED as bf16 (bf16 path) or int8 (int
    path); both are exact because requant outputs are ints in [0,127],
    and both move a quarter or half of the bytes an int32 carry would.
    `carry` overrides that dtype (chip_smoke.py times an int32 carry
    against int8 on the card)."""
    if impl == "bf16":
        conv = lambda v, i: _conv_bf16(v.astype(jnp.bfloat16), mp.w_bf16[i], mp.b_i32[i])
        act_dtype = jnp.bfloat16
    elif impl == "int":
        conv = lambda v, i: _conv_int(v, mp.w_i8[i], mp.b_i32[i], mp.int_groups[i])
        act_dtype = jnp.int8
    else:
        raise ValueError(f"unknown conv impl {impl!r}; expected 'int' or 'bf16'")
    act_dtype = carry or act_dtype

    mask = _valid_mask(row_valid, col_valid)

    def requant(u, i):
        mid = jnp.right_shift((u + mp.bias_pre[i]) * mp.mul[i], mp.shift[i])
        v = jnp.where(u > mp.blu_q[i], 127, jnp.where(u < 0, 0, mid))
        return mask(v.astype(act_dtype))

    x0 = mask(x_ppro.astype(act_dtype))
    v1 = requant(conv(x0, 0), 0)
    v2 = requant(conv(v1, 1), 1)
    v3 = requant(conv(v2, 2), 2)
    u4 = conv(v3, 3)
    return final_residual_i32(u4, mp.mul4, mp.shift4)[..., 0]


def _valid_mask(row_valid: Optional[jnp.ndarray], col_valid: Optional[jnp.ndarray]):
    """Stage-output mask from optional [H] row / [W] col validity vectors
    (broadcast product on [N, H, W, C] activations)."""
    if row_valid is None and col_valid is None:
        return lambda v: v
    m = None
    if row_valid is not None:
        m = row_valid[None, :, None, None]
    if col_valid is not None:
        cv = col_valid[None, None, :, None]
        m = cv if m is None else (m & cv)
    return lambda v: jnp.where(m, v, jnp.zeros((), v.dtype))


def _conv_bf16(x_bf16, w_bf16, b_i32):
    u = lax.conv_general_dilated(
        x_bf16,
        w_bf16,
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=_DIM_NUMBERS,
        preferred_element_type=jnp.float32,
    )
    return u.astype(jnp.int32) + b_i32


def _conv_int(x, w_i8, b_i32, groups: int = 1):
    """int8 x int8 conv, accumulator returned as f32 (the form cuDNN runs:
    int32 accumulation, f32 output) over `groups` input-channel slices,
    each exact below 2^24 (int_conv_groups), summed in int32."""
    x = x.astype(jnp.int8)
    step = x.shape[-1] // groups
    acc = b_i32
    for g in range(groups):
        cs = slice(g * step, (g + 1) * step)
        u = lax.conv_general_dilated(
            x[..., cs],
            w_i8[:, :, cs],
            window_strides=(1, 1),
            padding="SAME",
            dimension_numbers=_DIM_NUMBERS,
            preferred_element_type=jnp.float32,
        )
        acc = acc + u.astype(jnp.int32)
    return acc


def resolve_impl(impl: ConvImpl, mp: ModelParams) -> str:
    """The conv form to run. 'auto' is 'int' on every platform: on one
    H100 at 1920x1080, batch 16, int took about half bf16's time per frame
    (chip_smoke.py phase 5; numbers in PERF.md), int is exact for every
    model, and on the CPU it is the plain integer path the tests certify. An explicit 'bf16' for a
    model outside the bf16 certificate raises: it would not be exact."""
    if impl == "auto":
        return "int"
    if impl not in ("int", "bf16"):
        raise ValueError(f"unknown conv impl {impl!r}; expected auto, int or bf16")
    if impl == "bf16" and not mp.exact_bf16:
        raise ValueError("model fails the bf16 exactness certificate; use impl='int'")
    return impl


def residual_blu(
    x_ppro: jnp.ndarray,
    mp: ModelParams,
    impl: str = "int",
    row_valid: Optional[jnp.ndarray] = None,
    col_valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """The 6-conv/2-concat core on preprocessed input.

    x_ppro: [N, H, W, 1] int32 in [-128, 127] (= x_uint8 - 128).
    Returns the int32 residual [N, H, W] at raw pixel scale. Exposed
    separately from the uint8 wrapper so halo-exchange spatial sharding can
    run the core on halo-extended blocks and crop before the residual add.

    row_valid: optional [H] bool mask marking rows INSIDE the frame. The
    unsharded engine zero-pads at every layer (SAME), so on frame-boundary
    shards the halo rows must read as zeros to EVERY conv, not just the
    first — intermediate activations there are requant(conv(0)+b) != 0.
    Masking each stage's output on invalid rows reproduces per-layer
    padding exactly (spatial-sharding bit-exactness depends on this).

    Activations travel between stages as int8-valued int32 (int path) or
    bfloat16 (bf16 path); BLU outputs are in [0,127] so both are exact.
    """
    if impl == "bf16":
        conv = lambda v, i: _conv_bf16(v.astype(jnp.bfloat16), mp.weights_bf16[i], mp.biases_i32[i])
    else:
        conv = lambda v, i: _conv_int(
            v, mp.weights_i8[i], mp.biases_i32[i], mp.int_groups[i]
        )

    mask = _valid_mask(row_valid, col_valid)

    def requant(u, i):
        return mask(blu_requant_i32(u, mp.blu_q[i], mp.mul[i], mp.shift[i]))

    v1 = requant(conv(mask(x_ppro), 0), 0)
    conc1 = jnp.concatenate([requant(conv(v1, 1), 1), requant(conv(v1, 2), 2)], axis=-1)
    conc2 = jnp.concatenate(
        [requant(conv(conc1, 3), 3), requant(conv(conc1, 4), 4)], axis=-1
    )
    u4 = conv(conc2, 5)
    return final_residual_i32(u4, mp.mul[5], mp.shift[5])[..., 0]


def forward_blu(
    x_uint8: jnp.ndarray, mp: ModelParams, impl: str = "int"
) -> jnp.ndarray:
    """The production static-fused pipeline on [N, H, W] uint8 frames."""
    x = x_uint8[..., None].astype(jnp.int32) - 128  # ppro (cnn.cu:449)
    res = residual_blu(x, mp, impl)
    return apply_residual_u8(x_uint8, res)


def make_forward(p: EngineParams, impl: ConvImpl = "auto", merged: bool = True):
    """Build a jitted fn(uint8 [N,H,W]) -> uint8 [N,H,W] restorer.

    merged=True (default) uses the branch-merged 4-conv program;
    merged=False keeps the literal 6-conv graph (debug parity with the
    reference's per-layer structure). `run.lower(x)` exposes the jitted
    program for compile-time inspection (memory_analysis, HLO)."""
    mp = ModelParams.from_engine(p)
    chosen = resolve_impl(impl, mp)

    if merged:
        mpar = MergedParams.from_engine(p)

        @jax.jit
        def run_impl(x_uint8):
            x = x_uint8[..., None].astype(jnp.int32) - 128
            res = residual_blu_merged(x, mpar, chosen)
            return apply_residual_u8(x_uint8, res)

    else:

        @jax.jit
        def run_impl(x_uint8):
            return forward_blu(x_uint8, mp, chosen)

    def run(x_uint8):
        return run_impl(x_uint8)

    run.model_params = mp
    run.impl = chosen
    run.merged = merged
    run.lower = run_impl.lower
    return run
