"""Float VRCNN training — functional JAX/optax re-design of model.py:112-149.

The reference trains with TF1 Adam on 64x64 patch batches (L2 loss over
normalized pixels, per-epoch checkpoints). Here the train step is ONE jitted
SPMD program over a (dp, sp) mesh:

  dp — batch sharding (the classic data parallel the reference lacks)
  sp — spatial row sharding with differentiable halo exchange, so frames
       far larger than one chip's HBM can be trained on directly (the
       training-side generalization of divided_run, model.py:235-255)

Gradients are psum'd over the mesh inside the step (replicated optimizer
state), which replaces the reference's
single-process loop. For sp>1 the same per-layer row-masking trick as the
int engine keeps the sharded forward mathematically identical to the
unsharded one, so the gradient is exact too (loss is a sum over kept rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from qcnn_gpu.models import float_model as FM
from qcnn_gpu.models.topology import RECEPTIVE_RADIUS
from qcnn_gpu.parallel.spatial import halo_exchange_rows


@dataclasses.dataclass
class TrainConfig:
    qp: int = 37
    blu: bool = False
    lr: float = 1e-4  # main.py:19
    batch_size: int = 64  # main.py:14
    patch: int = 64  # main.py:15 sub_image_size
    epochs: int = 30  # main.py:10
    seed: int = 0
    log_every: int = 10


def dump_image_triplet(image_dir, step, inp, out, target) -> str:
    """Write one input|output|target side-by-side PNG — the reference's
    tf.summary.image triplet (model.py:61-69) as a plain file artifact.
    inp/out/target: uint8 [H, W]. Returns the written path."""
    import os

    os.makedirs(image_dir, exist_ok=True)
    sep = np.full((inp.shape[0], 4), 255, np.uint8)
    strip = np.concatenate([inp, sep, out, sep, target], axis=1)
    path = os.path.join(image_dir, f"triplet_{step:07d}.png")
    try:
        from PIL import Image

        Image.fromarray(strip, "L").save(path)
    except ImportError:  # PNG writer unavailable: fall back to raw PGM
        path = path[:-4] + ".pgm"
        with open(path, "wb") as fp:
            fp.write(b"P5\n%d %d\n255\n" % (strip.shape[1], strip.shape[0]))
            fp.write(strip.tobytes())
    return path


def _masked_residual(params, x_norm, blu_ub, row_valid):
    """Float residual with per-layer row masking (halo correctness)."""

    def act(x, i):
        a = jnp.maximum(x, 0.0) if blu_ub is None else jnp.clip(x, 0.0, blu_ub[i])
        return jnp.where(row_valid[None, :, None, None], a, 0.0)

    def conv(x, name):
        return FM._conv(x, params[f"w_{name}"], params[f"b_{name}"])

    x_norm = jnp.where(row_valid[None, :, None, None], x_norm, 0.0)
    a1 = act(conv(x_norm, "C1"), 0)
    c2 = jnp.concatenate([act(conv(a1, "C2_1"), 1), act(conv(a1, "C2_2"), 2)], axis=-1)
    c3 = jnp.concatenate([act(conv(c2, "C3_1"), 3), act(conv(c2, "C3_2"), 4)], axis=-1)
    return conv(c3, "C4")


def make_grad_fn(
    mesh: Mesh,
    blu_ub: Optional[Sequence[float]] = None,
    halo: int = RECEPTIVE_RADIUS,
):
    """Sharded (loss, grads) function over the (dp, sp) mesh — shared by
    float training and the quant fine-tune loop."""

    def local_loss(params, images, labels):
        # images: [N/dp, H/sp, W, 1]
        x = (images - 128.0) / 255.0
        y = (labels - 128.0) / 255.0
        xe = halo_exchange_rows(x, "sp", halo)
        idx = lax.axis_index("sp")
        n_sp = lax.axis_size("sp")
        h_ext = xe.shape[1]
        row = jnp.arange(h_ext)
        row_valid = (row >= jnp.where(idx == 0, halo, 0)) & (
            row < jnp.where(idx == n_sp - 1, h_ext - halo, h_ext)
        )
        res = _masked_residual(params, xe, blu_ub, row_valid)[:, halo:-halo]
        pred = res + x
        # tf.nn.l2_loss: 0.5 * sum of squares (model.py:59), local rows only
        return 0.5 * jnp.sum(jnp.square(y - pred))

    def sharded_grad(params, images, labels):
        # Grad locally, THEN psum: each shard's local loss depends on params
        # only through its own forward (the halo carries data, not params),
        # so psum of local grads IS the exact global-batch gradient. (psum
        # of the loss before grad does NOT produce summed grads — the
        # transpose delivers only the local cotangent.)
        loss, grads = jax.value_and_grad(local_loss)(params, images, labels)
        loss = lax.psum(lax.psum(loss, "dp"), "sp")
        grads = jax.tree_util.tree_map(
            lambda g: lax.psum(lax.psum(g, "dp"), "sp"), grads
        )
        return loss, grads

    return jax.shard_map(
        sharded_grad,
        mesh=mesh,
        in_specs=(P(), P("dp", "sp", None, None), P("dp", "sp", None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )


def make_train_step(
    mesh: Mesh,
    blu_ub: Optional[Sequence[float]] = None,
    lr: float = 1e-4,
    halo: int = RECEPTIVE_RADIUS,
):
    """Returns (step_fn, opt_init_fn). step_fn(params, opt_state, images,
    labels) -> (params, opt_state, loss); images/labels are raw-valued
    float32 [N, H, W, 1] sharded (dp, sp) on entry."""
    tx = optax.adam(lr)
    grad_fn = make_grad_fn(mesh, blu_ub, halo)

    @jax.jit
    def step(params, opt_state, images, labels):
        loss, grads = grad_fn(params, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, tx.init


class Trainer:
    """Orchestrates training: data pipeline, step loop, checkpoints."""

    def __init__(
        self,
        cfg: TrainConfig,
        mesh: Optional[Mesh] = None,
        blu_ub: Optional[Sequence[float]] = None,
        params: Optional[FM.Params] = None,
    ):
        from qcnn_gpu.parallel.mesh import make_mesh

        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(len(jax.devices()), 1)
        self.blu_ub = list(blu_ub) if blu_ub is not None else None
        self.params = params if params is not None else FM.init_params(cfg.seed)
        self.step_fn, opt_init = make_train_step(self.mesh, self.blu_ub, cfg.lr)
        self.opt_state = opt_init(self.params)
        self.global_step = 0

    def fit_batches(
        self,
        batches,
        log_fn=print,
        metrics_path: Optional[str] = None,
        image_dir: Optional[str] = None,
    ):
        """batches: iterable of (images, labels) float32 [N, H, W, 1] raw-
        valued arrays (labels = originals, images = codec anchors — note
        the reference feeds batch[1] as images, batch[0] as labels,
        model.py:140).

        metrics_path: optional JSONL sink for per-log-step scalars (loss +
        batch PSNR) — the structured replacement for the reference's
        TensorBoard summaries (model.py:61-69, 116-117, 144-145).

        image_dir: optional directory receiving an input|output|target
        triptych PNG at every log step — the analog of the reference's
        tf.summary.image triplet (model.py:61-69)."""
        import json
        import math
        import time as _time

        loss = None
        last_batch = None
        for images, labels in batches:
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, images, labels
            )
            self.global_step += 1
            last_batch = (images, labels)
            if self.cfg.log_every and self.global_step % self.cfg.log_every == 0:
                # batch PSNR in the raw-pixel domain (the summary scalar
                # PSNR of model.py:63-66)
                from qcnn_gpu.models import float_model as FM

                pred = FM.residual_float(self.params, (images - 128.0) / 255.0, self.blu_ub)
                pred = pred + (images - 128.0) / 255.0
                import numpy as np

                mse = float(np.mean((np.asarray(pred) * 255.0 + 128.0 - labels) ** 2))
                psnr = 10.0 * math.log10(255.0**2 / mse) if mse > 0 else float("inf")
                log_fn(
                    f"step {self.global_step}: loss {float(loss):.6f} "
                    f"batch-PSNR {psnr:.2f} dB"
                )
                if metrics_path:
                    with open(metrics_path, "a") as fp:
                        fp.write(
                            json.dumps(
                                {
                                    "step": self.global_step,
                                    "loss": float(loss),
                                    "batch_psnr": psnr,
                                    "ts": _time.time(),
                                }
                            )
                            + "\n"
                        )
                if image_dir:
                    out = np.clip(
                        np.asarray(pred) * 255.0 + 128.0, 0, 255
                    ).astype(np.uint8)
                    dump_image_triplet(
                        image_dir, self.global_step,
                        images[0, ..., 0].astype(np.uint8),
                        out[0, ..., 0],
                        labels[0, ..., 0].astype(np.uint8),
                    )
        return float(loss) if loss is not None else None

    # -- checkpointing (replacing tf.train.Saver, model.py:70,146-149) --
    def save_checkpoint(self, path: str) -> None:
        from qcnn_gpu.train.checkpoint import save_checkpoint

        save_checkpoint(path, self.params, self.opt_state, self.global_step)

    def load_checkpoint(self, path: str) -> None:
        from qcnn_gpu.train.checkpoint import load_checkpoint

        self.params, self.opt_state, self.global_step = load_checkpoint(
            path, self.params, self.opt_state
        )
