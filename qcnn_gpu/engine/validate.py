"""Cross-implementation validation & golden-dump tooling.

The reference's verification machinery, formalized (SURVEY.md §4):
  * conv_validation (model.py:366-383): run the FLOAT graph, scale each
    layer's x/w/b/conv by the layer's ratio/stepw into the integer domain,
    and compare against what the INT engine actually computes;
  * viewmem (cnn.cu:203-248): per-stage corner dumps of x/w/u/v with
    mul/shift — here a structured per-layer diff report instead of eyeball
    printf matching;
  * dump_feature (model.py:342-364): golden activation tensors to disk;
  * oracle windows: the integer oracle on small regions of a large frame,
    so a full-HD or 4K restoration is checked pixel-exactly where the
    oracle itself would take minutes on the whole frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from qcnn_gpu.models import float_model as FM
from qcnn_gpu.models import oracle as O
from qcnn_gpu.models.topology import QVRCNN_LAYERS, RECEPTIVE_RADIUS
from qcnn_gpu.quant.params import QuantTable


@dataclasses.dataclass
class LayerDiff:
    name: str
    max_abs_diff: float  # float-model-int-domain vs engine accumulator
    mean_abs_diff: float
    engine_corner: np.ndarray  # 5x5 corner of the engine value (viewmem)
    float_corner: np.ndarray


def conv_validation(
    float_params: FM.Params,
    table: QuantTable,
    engine_params: O.EngineParams,
    frames: np.ndarray,
) -> List[LayerDiff]:
    """Per-layer comparison of the float model's integer-scaled
    accumulators vs the INT engine's exact accumulators.

    The float value of layer L's pre-activation, multiplied by
    ratio_in/stepw (conv_validation's scaling, model.py:379-382), should
    land within quantization error of the engine's int32 accumulator u.
    Large deviations localize numeric breakage to a layer — the diff this
    tool reports is what the reference's manual printf-vs-printf compare
    established by eye. The float graph runs at precision=HIGHEST (no TF32
    rounding on a GPU), so the diff is quantization error alone; its test
    bounds it relative to each layer's accumulator scale (blu_q).
    """
    x_norm = (frames[..., None].astype(np.float32) - 128.0) / 255.0
    with jax.default_matmul_precision("highest"):
        pre = _float_preacts(float_params, table, jnp.asarray(x_norm))

    _, inter = O.forward_blu(frames, engine_params, collect_intermediates=True)
    engine_u = {
        "C1": inter["u1"],
        "C2_1": inter["u2_1"],
        "C2_2": inter["u2_2"],
        "C3_1": inter["u3_1"],
        "C3_2": inter["u3_2"],
        "C4": inter["u4"],
    }

    out = []
    for i, layer in enumerate(QVRCNN_LAYERS):
        row = table[i]
        scaled = np.asarray(pre[layer.name]) * (row.ratio / row.stepw)
        eng = engine_u[layer.name].astype(np.float64)
        diff = np.abs(scaled - eng)
        out.append(
            LayerDiff(
                name=layer.name,
                max_abs_diff=float(diff.max()),
                mean_abs_diff=float(diff.mean()),
                engine_corner=eng[0, :5, :5, 0].copy(),
                float_corner=np.round(scaled[0, :5, :5, 0]).copy(),
            )
        )
    return out


def _float_preacts(float_params: FM.Params, table: QuantTable, xj) -> Dict:
    """Float pre-activations of every layer (the BLU variant, clipped at
    the table's float-domain bounds), keyed by layer name."""
    blu_ub = table.blu_adj

    def conv(x, name):
        return FM._conv(x, float_params[f"w_{name}"], float_params[f"b_{name}"])

    pre = {"C1": conv(xj, "C1")}
    a1 = jnp.clip(pre["C1"], 0, blu_ub[0])
    pre["C2_1"] = conv(a1, "C2_1")
    pre["C2_2"] = conv(a1, "C2_2")
    c2 = jnp.concatenate(
        [jnp.clip(pre["C2_1"], 0, blu_ub[1]), jnp.clip(pre["C2_2"], 0, blu_ub[2])],
        axis=-1,
    )
    pre["C3_1"] = conv(c2, "C3_1")
    pre["C3_2"] = conv(c2, "C3_2")
    c3 = jnp.concatenate(
        [jnp.clip(pre["C3_1"], 0, blu_ub[3]), jnp.clip(pre["C3_2"], 0, blu_ub[4])],
        axis=-1,
    )
    pre["C4"] = conv(c3, "C4")
    return {k: np.asarray(v) for k, v in pre.items()}


def dump_features(
    engine_params: O.EngineParams, frames: np.ndarray, path: str
) -> Dict[str, np.ndarray]:
    """Golden activation dump (dump_feature analog): writes the six
    post-requant activation tensors for `frames` to `path` as raw arrays
    in layer order, returns them keyed by name."""
    _, inter = O.forward_blu(frames, engine_params, collect_intermediates=True)
    conc1 = inter["conc1"]
    conc2 = inter["conc2"]
    feats = {
        "blu1": inter["v1"],
        "blu2_1": conc1[..., :32],
        "blu2_2": conc1[..., 32:],
        "blu3_1": conc2[..., :16],
        "blu3_2": conc2[..., 16:],
        "conv4": inter["u4"],
    }
    with open(path, "wb") as fp:
        for name in ("blu1", "blu2_1", "blu2_2", "blu3_1", "blu3_2", "conv4"):
            fp.write(np.asarray(feats[name], dtype="<i4").tobytes())
    return feats


def viewmem_report(
    engine_params: O.EngineParams, frames: np.ndarray
) -> str:
    """Human-readable per-stage corner dump (viewmem analog, cnn.cu:203-248):
    5x5 corners of each accumulator and requantized output + mul/shift."""
    _, inter = O.forward_blu(frames, engine_params, collect_intermediates=True)
    lines = []
    stages = [
        ("C1", "u1", "v1", 0),
        ("C2_1", "u2_1", None, 1),
        ("C2_2", "u2_2", None, 2),
        ("C3_1", "u3_1", None, 3),
        ("C3_2", "u3_2", None, 4),
        ("C4", "u4", None, 5),
    ]
    for name, ukey, vkey, idx in stages:
        lines.append(f"== {name} ==")
        lines.append(
            f"mul:{engine_params.mul[idx]} shift:{engine_params.shift[idx]} "
            f"blu:{engine_params.blu_q[idx]}"
        )
        lines.append("u:")
        for r in inter[ukey][0, :5, :5, 0]:
            lines.append("\t".join(str(int(v)) for v in r))
        if vkey:
            lines.append("v:")
            for r in inter[vkey][0, :5, :5, 0]:
                lines.append("\t".join(str(int(v)) for v in r))
    return "\n".join(lines)


def window_origins(h: int, w: int, size: int):
    """Top-left corners of the nine `size` x `size` check regions of an
    h x w frame: the four corners, the four edge midpoints and the centre."""
    ys = (0, (h - size) // 2, h - size)
    xs = (0, (w - size) // 2, w - size)
    return [(y, x) for y in ys for x in xs]


def oracle_windows(frames: np.ndarray, engine_params: O.EngineParams, size: int = 32):
    """The oracle's output on the nine check regions of every frame.

    Each region is computed from itself grown by RECEPTIVE_RADIUS (6 px)
    and clamped to the frame: where the grown window meets the frame edge,
    the oracle's own per-layer zero padding is the whole frame's; elsewhere
    every kept pixel lies >= 6 px inside the window, so its receptive field
    holds only real pixels (the rule of engine/tiled.py). Hence each region
    equals the same region of the whole-frame oracle, bit for bit.
    Returns [((y, x), uint8 [N, size, size])]."""
    frames = np.asarray(frames)
    _, h, w = frames.shape
    r = RECEPTIVE_RADIUS
    out = []
    for y, x in window_origins(h, w, size):
        y0, x0 = max(y - r, 0), max(x - r, 0)
        y1, x1 = min(y + size + r, h), min(x + size + r, w)
        o = O.forward_blu(frames[:, y0:y1, x0:x1], engine_params)
        out.append(((y, x), o[:, y - y0 : y - y0 + size, x - x0 : x - x0 + size]))
    return out


def windows_mismatch(restored: np.ndarray, windows) -> int:
    """Number of pixels of `restored` [N, H, W] that differ from the
    oracle_windows regions."""
    bad = 0
    for (y, x), want in windows:
        s = want.shape[-1]
        bad += int((np.asarray(restored)[:, y : y + s, x : x + s] != want).sum())
    return bad
