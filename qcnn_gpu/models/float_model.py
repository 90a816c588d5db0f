"""Float VRCNN in JAX — the training-side twin of the int8 engine.

Functional re-design of the TF1 graph (`training/model.py:29-110`): a plain
params pytree + pure functions, jit/vmap/pjit-friendly. Two activation
variants, as in the reference:
  * relu  — initial float training        (model(), model.py:72-92)
  * blu   — clip(x, 0, blu_ub[i]) retrain (model_blu(), model.py:94-110)

Normalization contract (model.py:32-33): x_norm = (x - 128)/255; the net
predicts a residual in normalized units; pred = residual + x_norm; raw
pixels = pred*255 + 128 (model.py:285).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from qcnn_gpu.models.topology import QVRCNN_LAYERS, weight_shape_hwio

_DIM_NUMBERS = ("NHWC", "HWIO", "NHWC")

Params = Dict[str, jnp.ndarray]


def init_params(seed: int = 0, dtype=jnp.float32) -> Params:
    """He/variance-scaling init (model.py:35-40 uses
    variance_scaling_initializer; biases zero, model.py:43-48)."""
    rng = np.random.default_rng(seed)
    params = {}
    for layer in QVRCNN_LAYERS:
        shape = weight_shape_hwio(layer)
        fan_in = layer.ksize * layer.ksize * layer.in_ch
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=shape)
        params[f"w_{layer.name}"] = jnp.asarray(w, dtype=dtype)
        params[f"b_{layer.name}"] = jnp.zeros((layer.out_ch,), dtype=dtype)
    return params


def params_to_lists(params: Params):
    ws = [params[f"w_{l.name}"] for l in QVRCNN_LAYERS]
    bs = [params[f"b_{l.name}"] for l in QVRCNN_LAYERS]
    return ws, bs


def lists_to_params(ws: Sequence, bs: Sequence) -> Params:
    out = {}
    for layer, w, b in zip(QVRCNN_LAYERS, ws, bs):
        out[f"w_{layer.name}"] = jnp.asarray(w)
        out[f"b_{layer.name}"] = jnp.asarray(b)
    return out


def _conv(x, w, b):
    return (
        lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=_DIM_NUMBERS
        )
        + b
    )


def residual_float(
    params: Params,
    x_norm: jnp.ndarray,
    blu_ub: Optional[Sequence[float]] = None,
    collect: bool = False,
):
    """x_norm: [N, H, W, 1] normalized input -> residual [N, H, W, 1].

    blu_ub None => ReLU variant; else the 6-vector of BLU upper bounds
    (last entry unused — C4 is linear)."""

    def act(x, i):
        if blu_ub is None:
            return jnp.maximum(x, 0.0)
        return jnp.clip(x, 0.0, blu_ub[i])

    acts = {}

    def conv(x, name):
        return _conv(x, params[f"w_{name}"], params[f"b_{name}"])

    a1 = act(conv(x_norm, "C1"), 0)
    a2_1 = act(conv(a1, "C2_1"), 1)
    a2_2 = act(conv(a1, "C2_2"), 2)
    c2 = jnp.concatenate([a2_1, a2_2], axis=-1)
    a3_1 = act(conv(c2, "C3_1"), 3)
    a3_2 = act(conv(c2, "C3_2"), 4)
    c3 = jnp.concatenate([a3_1, a3_2], axis=-1)
    res = conv(c3, "C4")
    if collect:
        acts = {"a1": a1, "a2_1": a2_1, "a2_2": a2_2, "a3_1": a3_1, "a3_2": a3_2, "res": res}
        return res, acts
    return res


def predict_uint8(params: Params, x_uint8: jnp.ndarray, blu_ub=None) -> jnp.ndarray:
    """Full float restoration of [N, H, W] uint8 frames -> uint8."""
    x_norm = (x_uint8[..., None].astype(jnp.float32) - 128.0) / 255.0
    pred = residual_float(params, x_norm, blu_ub) + x_norm
    raw = pred[..., 0] * 255.0 + 128.0
    return jnp.clip(jnp.round(raw), 0.0, 255.0).astype(jnp.uint8)


def predict_uint8_tiled(
    params: Params,
    x_uint8: jnp.ndarray,
    blu_ub=None,
    tile: int = 768,
    pad: int = 10,
) -> jnp.ndarray:
    """Tiled float restoration for frames too large for one pass — the
    divided_run analog (model.py:235-255): overlapping tiles with a
    `pad`-pixel halo (>= the receptive radius 6; the reference used 10),
    halo cropped at stitch time. Because pad exceeds the receptive radius,
    every kept pixel's receptive field lies inside its tile, so the output
    equals predict_uint8 exactly, everywhere."""
    import numpy as np

    x = np.asarray(x_uint8)
    n, h, w = x.shape
    out = np.empty_like(x)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            y1 = min(y0 + tile, h)
            x1 = min(x0 + tile, w)
            ys = max(0, y0 - pad)
            xs = max(0, x0 - pad)
            ye = min(h, y1 + pad)
            xe = min(w, x1 + pad)
            sub = x[:, ys:ye, xs:xe]
            pred = np.asarray(predict_uint8(params, jnp.asarray(sub), blu_ub))
            out[:, y0:y1, x0:x1] = pred[:, y0 - ys : y0 - ys + (y1 - y0),
                                        x0 - xs : x0 - xs + (x1 - x0)]
    return out


def l2_loss(params: Params, images: jnp.ndarray, labels: jnp.ndarray, blu_ub=None):
    """0.5 * sum((labels_norm - pred)^2), the tf.nn.l2_loss objective
    (model.py:59). images/labels: [N, H, W, 1] raw-valued float."""
    x_norm = (images - 128.0) / 255.0
    y_norm = (labels - 128.0) / 255.0
    pred = residual_float(params, x_norm, blu_ub) + x_norm
    return 0.5 * jnp.sum(jnp.square(y_norm - pred))


def activation_sigmas(params: Params, x_uint8: np.ndarray, blu_ub=None) -> List[float]:
    """Per-layer activation std-devs (pre-clip) for 3-sigma BLU calibration
    (the 'observed 3sigma' comments, quantization.py:70-76). Returns 6
    floats; the last is 0 (linear layer)."""
    x_norm = (jnp.asarray(x_uint8)[..., None].astype(jnp.float32) - 128.0) / 255.0

    def conv(x, name):
        return _conv(x, params[f"w_{name}"], params[f"b_{name}"])

    def act(x, i):
        if blu_ub is None:
            return jnp.maximum(x, 0.0)
        return jnp.clip(x, 0.0, blu_ub[i])

    u1 = conv(x_norm, "C1")
    a1 = act(u1, 0)
    u2_1, u2_2 = conv(a1, "C2_1"), conv(a1, "C2_2")
    c2 = jnp.concatenate([act(u2_1, 1), act(u2_2, 2)], axis=-1)
    u3_1, u3_2 = conv(c2, "C3_1"), conv(c2, "C3_2")
    sigmas = [float(jnp.std(u)) for u in (u1, u2_1, u2_2, u3_1, u3_2)]
    return sigmas + [0.0]
