"""Quantization-aware fine-tune — the shadow-weight scheme of model.py:170-233.

Contract (per reference step):
  * the model always runs on grid weights  wq = round(wf/stepw)*stepw
    (initialized with a clip to [-128, 127] steps, model.py:199-202);
  * Adam's update delta is folded back into the float shadow wf, which is
    clipped to the representable range [-128*stepw, 127*stepw]
    (model.py:218-222: we = wn - wq; wf += we; clip; requantize);
  * biases keep training in plain float (their quantize-assign is
    commented out in the reference, model.py:203-206/223-227).

Functional restatement used here (algebraically identical):
    wn  = wq + update        =>  we = update
    wf' = clip(wf + update)  ;   wq' = round(wf'/stepw)*stepw
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from qcnn_gpu.models.topology import QVRCNN_LAYERS
from qcnn_gpu.train.trainer import make_grad_fn


def _quantize_w(wf, stepw):
    return jnp.round(wf / stepw) * stepw


def quant_finetune(
    params,
    stepw: Sequence[float],
    mesh: Mesh,
    batches,
    blu_ub: Optional[Sequence[float]] = None,
    lr: float = 1e-4,
    log_every: int = 10,
    log_fn=print,
    wbits: int = 8,
):
    """Run the shadow-weight fine-tune over `batches` of (images, labels)
    raw-valued float32 [N,H,W,1]. Returns params whose weights sit exactly
    on the signed `wbits` grid (round(w/stepw) in [-2^(b-1), 2^(b-1)-1];
    wbits=4 is the INT4 stretch variant — same shadow-weight contract,
    coarser grid)."""
    qlo, qhi = float(-(1 << (wbits - 1))), float((1 << (wbits - 1)) - 1)
    tx = optax.adam(lr)
    grad_fn = make_grad_fn(mesh, blu_ub)
    step_map = {l.name: stepw[i] for i, l in enumerate(QVRCNN_LAYERS)}

    # shadow floats; initial clip onto the grid range (model.py:199-202)
    wf = dict(params)
    for name, s in step_map.items():
        wf[f"w_{name}"] = jnp.clip(
            jnp.round(params[f"w_{name}"] / s), qlo, qhi
        ) * s

    opt_state = tx.init(wf)

    @jax.jit
    def step(wf, opt_state, images, labels):
        wq = dict(wf)
        for name, s in step_map.items():
            wq[f"w_{name}"] = _quantize_w(wf[f"w_{name}"], s)
        loss, grads = grad_fn(wq, images, labels)
        updates, opt_state = tx.update(grads, opt_state, wq)
        new_wf = dict(wf)
        for key in wf:
            new_wf[key] = wf[key] + updates[key]
        for name, s in step_map.items():
            k = f"w_{name}"
            new_wf[k] = jnp.clip(new_wf[k], qlo * s, qhi * s)
        return new_wf, opt_state, loss

    n = 0
    loss = None
    for images, labels in batches:
        wf, opt_state, loss = step(wf, opt_state, images, labels)
        n += 1
        if log_every and n % log_every == 0:
            log_fn(f"finetune step {n}: loss {float(loss):.6f}")

    # final grid weights (sess.run(update) before save, model.py:228)
    out = dict(wf)
    for name, s in step_map.items():
        out[f"w_{name}"] = _quantize_w(wf[f"w_{name}"], s)
    return out
