"""Smoke run of the INT8 restoration engine on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --four-cards  # four cards: the mesh phases only

One card, through the entry points a user calls, with the committed
trained weights (assets/golden), at the full model width:

  1. device check: the JAX platform must be 'gpu' (no CPU fallback);
  2. card line: `nvidia-smi --query-gpu=name,power.limit`, read by a child
     process that stays off JAX; every later number carries that tag;
  3. `qcnn_gpu.cli run` on 8 synthetic 1920x1080 frames (all-0 and all-255
     frames among them) with model_q37.data;
  4. `Engine.run_sequence` at 1920x1080 with the QP22/27/32 INT8 models and
     one per-channel INT4 model, `Engine.restore` of whole 3840x2160
     frames, and 416x240 at batch 1, with the 1080p and 4K programs'
     memory_analysis(), compile seconds and peak device memory;
  5. the int and bf16 conv forms, each also unmerged (merged=False), and
     int with an int32 carry, timed at 1920x1080, batch 16, on
     device-resident frames, outputs asserted equal; int == bf16 on whole
     3840x2160 and 416x240 frames;
  6. 3 Trainer steps and 1 quant_finetune step on 64x64 patches;
  7. the tests marked `gpu` (pytest, in this process).

Four cards: a dp=4 Engine restore at 1920x1080, a (dp=1, sp=2, sw=2)
make_sharded_forward at 3840x2160 with halos over NCCL, each compared bit
for bit with the one-card program, and 3 dp=4 trainer steps compared with
one-card steps at the same global batch under precision=HIGHEST
(gradients, losses and final parameters, each to a stated tolerance).

Every restoration is compared with the integer oracle (models/oracle.py):
whole frames at 416x240, and at 1080p and 4K the nine regions of
engine/validate.oracle_windows. Any failure raises, so the script exits
non-zero; the last line of standard output is the device record
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "assets", "golden")
BASELINE_FPS_1080P = 23.6  # the reference's best 1080p end-to-end (BASELINE.md)
TAG = ""  # "[<card name>, <power limit>]", set by main() from nvidia-smi


def say(msg: str) -> None:
    print(f"{TAG} {msg}" if TAG else msg, flush=True)


# ---- phase 1-2: device and card -------------------------------------------


def require_gpu(n: int = 1):
    """The first `n` JAX devices, which must be GPUs; SystemExit otherwise."""
    import jax

    try:
        platform = jax.default_backend()
    except RuntimeError as e:  # the configured GPU backend could not start
        raise SystemExit(f"chip_smoke: no GPU backend: {e}") from None
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX platform is {platform!r}; this script runs only on an NVIDIA GPU"
        )
    devices = jax.devices()
    if len(devices) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, found {len(devices)}")
    return devices[:n]


def query_cards() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def parse_card_line(line: str):
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> ('NVIDIA H100 80GB HBM3', '700.00 W')."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def result_line(devices) -> str:
    """The last line of the run: the device as JAX reports it."""
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}}
    )


# ---- shared helpers --------------------------------------------------------


def golden_model(name: str):
    from qcnn_gpu.data.model_files import read_static_qfp_auto

    return read_static_qfp_auto(os.path.join(GOLDEN, name))


def check_oracle(restored: np.ndarray, frames: np.ndarray, params, what: str) -> None:
    """Whole-frame oracle equality at small frames, oracle windows above."""
    from qcnn_gpu.engine.validate import oracle_windows, windows_mismatch
    from qcnn_gpu.models import oracle as O

    restored = np.asarray(restored)
    if frames.shape[1] * frames.shape[2] <= 416 * 240:
        bad = int((restored != O.forward_blu(frames, params)).sum())
        how = "whole frames"
    else:
        bad = windows_mismatch(restored, oracle_windows(frames, params))
        how = "9 oracle windows/frame"
    if bad:
        raise AssertionError(f"{what}: {bad} pixels differ from the oracle ({how})")
    say(f"{what}: bit-exact vs oracle ({how}, {frames.shape[0]} frames)")


def clip_frames(n: int, h: int, w: int, seed: int = 1):
    """(original, anchor) uint8 [n, h, w]: synthetic frames, the anchor a
    noisy copy whose first two frames are all-0 and all-255."""
    from qcnn_gpu.testing import synth_frames

    ori = synth_frames(n, h, w, seed=seed)
    noise = np.random.default_rng(seed).integers(-4, 5, ori.shape)
    anchor = np.clip(ori.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    anchor[0] = 0
    if n > 1:
        anchor[1] = 255
    return ori, anchor


def write_clip(tmp: str, ori: np.ndarray, anchor: np.ndarray, tag: str):
    from qcnn_gpu.data import yuv

    ori_p = os.path.join(tmp, f"ori_{tag}.yuv")
    anc_p = os.path.join(tmp, f"anchor_{tag}.yuv")
    yuv.write_y_as_420(ori_p, ori)
    yuv.write_y_as_420(anc_p, anchor)
    return ori_p, anc_p


def compile_report(run, x, what: str) -> None:
    """Compile seconds and memory_analysis() of a make_forward program."""
    t0 = time.perf_counter()
    compiled = run.lower(x).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    say(
        f"{what}: compile {dt:.2f} s; memory_analysis: argument "
        f"{ma.argument_size_in_bytes} B, output {ma.output_size_in_bytes} B, "
        f"temp {ma.temp_size_in_bytes} B, generated code {ma.generated_code_size_in_bytes} B"
    )


def peak_bytes(device, what: str) -> None:
    stats = device.memory_stats() or {}
    say(f"{what}: peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not measured')}")


# ---- phase 3: the CLI ------------------------------------------------------


def phase_cli(tmp: str, h: int, w: int, n: int) -> None:
    from qcnn_gpu import cli
    from qcnn_gpu.data import yuv

    ori, anchor = clip_frames(n, h, w)
    ori_p, anc_p = write_clip(tmp, ori, anchor, "cli")
    recon = os.path.join(tmp, "recon_cli.yuv")
    model = os.path.join(GOLDEN, "model_q37.data")
    rc = cli.main([
        "run", "--ori", ori_p, "--anchor", anc_p, "--height", str(h), "--width", str(w),
        "--frames", str(n), "--model", model, "--qp", "37", "--recon", recon,
        "--out-dir", tmp,
    ])
    if rc != 0:
        raise RuntimeError(f"cli run exited {rc}")
    check_oracle(yuv.read_y(recon, h, w, n), anchor, golden_model("model_q37.data"),
                 f"cli run {w}x{h} QP37")


# ---- phase 4: the Engine ---------------------------------------------------

ENGINE_MODELS = [  # (qp, file, Engine.load_model format)
    (22, "model_q22.data", "vect_c"),
    (27, "model_q27.data", "vect_c"),
    (32, "model_q32.data", "vect_c"),
    (22, "model_q22_int4.data", "pc"),  # per-channel INT4
]


def phase_engine(tmp: str, device, hd=(1080, 1920), uhd=(2160, 3840), small=(240, 416),
                 n_hd: int = 8, n_uhd: int = 2, n_small: int = 2) -> None:
    from qcnn_gpu.data import yuv
    from qcnn_gpu.engine import Engine
    from qcnn_gpu.models.qvrcnn import make_forward

    h, w = hd
    ori, anchor = clip_frames(n_hd, h, w, seed=2)
    ori_p, anc_p = write_clip(tmp, ori, anchor, "engine")
    eng = Engine(out_dir=tmp, batch_frames=4)
    compile_report(make_forward(golden_model("model_q22.data")),
                   np.zeros((eng.batch_frames, h, w), np.uint8),
                   f"{w}x{h} batch {eng.batch_frames} program")
    for qp, name, fmt in ENGINE_MODELS:
        eng.load_model(qp, os.path.join(GOLDEN, name), fmt=fmt)
        recon = os.path.join(tmp, f"recon_{name}.yuv")
        rec = eng.run_sequence(name, ori_p, anc_p, h, w, qp, frames=n_hd, recon_path=recon)
        say(f"Engine {name} {w}x{h}: {rec.fps:.2f} fps host to host ({n_hd} frames, "
            f"batch {eng.batch_frames}, impl {rec.impl}), PSNR {rec.psnr_before:.3f} -> "
            f"{rec.psnr_after:.3f} dB")
        check_oracle(yuv.read_y(recon, h, w, n_hd), anchor, golden_model(name),
                     f"Engine {name} {w}x{h}")
    peak_bytes(device, f"after {w}x{h}")

    # whole 4K frames, not host-tiled
    h, w = uhd
    p37 = golden_model("model_q37.data")
    _, big = clip_frames(n_uhd, h, w, seed=3)
    compile_report(make_forward(p37), big, f"{w}x{h} batch {n_uhd} program")
    eng4 = Engine(out_dir=tmp, batch_frames=n_uhd)
    eng4.set_model(37, p37)
    t0 = time.perf_counter()
    out = eng4.restore(big, 37)
    say(f"Engine.restore {w}x{h} x{n_uhd} (first call, compile included): "
        f"{time.perf_counter() - t0:.2f} s")
    check_oracle(out, big, p37, f"Engine.restore {w}x{h} QP37")
    peak_bytes(device, f"after {w}x{h}")

    # 416x240 at batch 1 (the reference's production loop shape)
    h, w = small
    ori, anchor = clip_frames(n_small, h, w, seed=4)
    ori_p, anc_p = write_clip(tmp, ori, anchor, "small")
    eng1 = Engine(out_dir=tmp, batch_frames=1)
    eng1.set_model(37, p37)
    recon = os.path.join(tmp, "recon_small.yuv")
    rec = eng1.run_sequence("small", ori_p, anc_p, h, w, 37, frames=n_small, recon_path=recon)
    say(f"Engine QP37 {w}x{h} batch 1: {rec.fps:.2f} fps host to host ({n_small} frames)")
    check_oracle(yuv.read_y(recon, h, w, n_small), anchor, p37, f"Engine QP37 {w}x{h} batch 1")


# ---- phase 5: the two conv forms -------------------------------------------

# name -> (impl, merged, carry): the two conv forms, each also as the
# literal 6-conv graph (merged=False), and the int form with activations
# carried between stages as int32 instead of int8
FORMS = {
    "int": ("int", True, None),
    "bf16": ("bf16", True, None),
    "int merged=False": ("int", False, None),
    "bf16 merged=False": ("bf16", False, None),
    "int int32-carry": ("int", True, "int32"),
}


def form_program(p, impl: str, merged: bool, carry):
    """make_forward's program, or the merged graph with another carry."""
    import jax
    import jax.numpy as jnp

    from qcnn_gpu.models.qvrcnn import MergedParams, apply_residual_u8, make_forward, residual_blu_merged

    if carry is None:
        return make_forward(p, impl=impl, merged=merged)
    mpar = MergedParams.from_engine(p)

    @jax.jit
    def run(x_uint8):
        x = x_uint8[..., None].astype(jnp.int32) - 128
        return apply_residual_u8(x_uint8, residual_blu_merged(x, mpar, impl, carry=jnp.dtype(carry)))

    return run


def time_forms(h: int = 1080, w: int = 1920, batch: int = 16, iters: int = 10, reps: int = 3):
    """Per form of FORMS: (first-call seconds, compile included; ms/frame
    per rep) on device-resident frames, in alternating order after
    warm-up. Asserts every form's output equals the int form's, and the
    int form equals the oracle."""
    import jax

    from qcnn_gpu.testing import synth_frames

    p = golden_model("model_q37.data")
    x = synth_frames(batch, h, w, seed=5)
    xd = jax.device_put(x)
    runs, first, outs = {}, {}, {}
    for name, form in FORMS.items():
        runs[name] = form_program(p, *form)
        t0 = time.perf_counter()
        outs[name] = np.asarray(jax.block_until_ready(runs[name](xd)))
        first[name] = time.perf_counter() - t0
    check_oracle(outs["int"], x, p, f"int {w}x{h} QP37")
    for name, out in outs.items():
        if not (out == outs["int"]).all():
            raise AssertionError(f"{name} differs from int at {w}x{h}: {int((out != outs['int']).sum())} px")
    times = {name: [] for name in runs}
    names = list(runs)
    for rep in range(reps):
        for name in names if rep % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = runs[name](xd)
            jax.block_until_ready(y)
            times[name].append((time.perf_counter() - t0) / (iters * batch) * 1e3)
    return {name: (first[name], times[name]) for name in runs}


def compare_forms(geos=((2160, 3840, 2), (240, 416, 2))) -> None:
    """int == bf16 on whole frames (all-0 and all-255 among them) at each
    (h, w, n), and int == the oracle."""
    from qcnn_gpu.models.qvrcnn import make_forward

    p = golden_model("model_q37.data")
    for h, w, n in geos:
        _, x = clip_frames(n, h, w, seed=8)
        a = np.asarray(make_forward(p, impl="int")(x))
        b = np.asarray(make_forward(p, impl="bf16")(x))
        if not (a == b).all():
            raise AssertionError(f"int and bf16 differ at {w}x{h}: {int((a != b).sum())} px")
        say(f"int == bf16 on {n} whole {w}x{h} frames")
        check_oracle(a, x, p, f"int {w}x{h} QP37")


def phase_forms(device, geos=((2160, 3840, 2), (240, 416, 2)), **kw) -> None:
    from qcnn_gpu.engine.mfu import mfu_report

    h, w = kw.get("h", 1080), kw.get("w", 1920)
    for name, (first, ts) in time_forms(**kw).items():
        med = float(np.median(ts))
        try:
            util = mfu_report(h * w, med, device.device_kind)["util_vs_int8_peak"]
        except ValueError:  # a card missing from the peak table has no utilization
            util = "not measured"
        say(f"{name} {w}x{h} batch {kw.get('batch', 16)} device-resident: "
            f"{' '.join(f'{t:.4f}' for t in ts)} ms/frame (median {med:.4f}, "
            f"{1e3 / med:.1f} fps, {1e3 / med / BASELINE_FPS_1080P:.2f}x the reference's 23.6; "
            f"useful-work share of int8 peak {util}); first call {first:.2f} s incl. compile")
    say(f"all {len(FORMS)} forms' outputs equal")
    compare_forms(geos)


# ---- phase 6: training -----------------------------------------------------


def patch_batches(n: int, batch: int, patch: int, seed: int = 0):
    """`n` (images, labels) float32 [batch, patch, patch, 1] pairs."""
    from qcnn_gpu.testing import synth_frames

    out = []
    for i in range(n):
        lab = synth_frames(batch, patch, patch, seed=seed + i).astype(np.float32)
        noise = np.random.default_rng(seed + i).normal(0, 4, lab.shape)
        img = np.clip(lab + noise, 0, 255).astype(np.float32)
        out.append((img[..., None], lab[..., None]))
    return out


def phase_train(batch: int = 16, patch: int = 64) -> None:
    import jax

    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.quant.solver import BLU_INIT
    from qcnn_gpu.testing import load_table
    from qcnn_gpu.train import TrainConfig, Trainer, quant_finetune

    mesh = make_mesh(1, 1)
    tr = Trainer(TrainConfig(batch_size=batch, patch=patch, log_every=0), mesh=mesh)
    t0 = time.perf_counter()
    loss = tr.fit_batches(patch_batches(3, batch, patch))
    if not np.isfinite(loss):
        raise AssertionError(f"Trainer loss {loss}")
    say(f"Trainer: 3 steps of {batch}x{patch}x{patch}, last loss {loss:.6f} "
        f"({time.perf_counter() - t0:.2f} s incl. compile)")
    table = load_table(37)
    (img, lab), = patch_batches(1, batch, patch, seed=9)
    out = quant_finetune(tr.params, table.stepw, mesh, [(img, lab)],
                         blu_ub=BLU_INIT[37], log_every=0)
    qloss = float(FM.l2_loss(out, jax.numpy.asarray(img), jax.numpy.asarray(lab), BLU_INIT[37]))
    if not np.isfinite(qloss):
        raise AssertionError(f"quant_finetune loss {qloss}")
    say(f"quant_finetune: 1 step, loss on its batch after the step {qloss:.6f}")


# ---- phase 7: the gpu-marked tests -----------------------------------------


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {int(rc)}")
    say("pytest -m gpu: passed")


# ---- four cards ------------------------------------------------------------


def phase_mesh_engine(tmp: str, devices, h: int = 1080, w: int = 1920) -> None:
    """dp=4 Engine restore == one-card Engine restore == oracle windows."""
    from qcnn_gpu.engine import Engine
    from qcnn_gpu.parallel.mesh import make_mesh

    p = golden_model("model_q22.data")
    _, frames = clip_frames(2 * len(devices), h, w, seed=6)
    one = Engine(out_dir=tmp, batch_frames=len(devices))
    one.set_model(22, p)
    many = Engine(mesh=make_mesh(len(devices), 1, devices=devices), out_dir=tmp,
                  batch_frames=len(devices))
    many.set_model(22, p)
    a, b = one.restore(frames, 22), many.restore(frames, 22)
    if not (a == b).all():
        raise AssertionError(f"dp={len(devices)} Engine differs from one card: {int((a != b).sum())} px")
    t0 = time.perf_counter()
    many.restore(frames, 22)
    dt = time.perf_counter() - t0
    say(f"dp={len(devices)} Engine.restore {w}x{h} x{len(frames)}: bit-exact vs one card; "
        f"warm restore {dt * 1e3:.1f} ms host to host")
    check_oracle(b, frames, p, f"dp={len(devices)} Engine {w}x{h}")


def phase_mesh_2d(devices, h: int = 2160, w: int = 3840) -> None:
    """(dp=1, sp=2, sw=2) sharded program == one-card program == oracle windows."""
    from qcnn_gpu.models.qvrcnn import make_forward
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.parallel.spatial import make_sharded_forward

    p = golden_model("model_q37.data")
    _, frames = clip_frames(1, h, w, seed=7)
    run = make_sharded_forward(p, make_mesh(1, 2, devices=devices, sw=2))
    a = np.asarray(make_forward(p)(frames))
    b = np.asarray(run(frames))
    if not (a == b).all():
        raise AssertionError(f"(1,2,2) sharded differs from one card: {int((a != b).sum())} px")
    say(f"(dp=1, sp=2, sw=2) make_sharded_forward {w}x{h}: bit-exact vs one card")
    check_oracle(b, frames, p, f"(1,2,2) sharded {w}x{h}")


# The two sides differ only in the order of the gradient sums (a psum of
# per-card sums against one sum), i.e. in the last bits of float32. Each
# step's gradients, taken at the same parameters, must agree to GRAD_RTOL of
# the leaf's largest entry: a lost or doubled psum is off by 25% or more.
# Adam moves a parameter by about lr per step whatever the gradient's
# scale, so where a gradient is near zero, rounding can turn two runs' steps
# apart: after 3 steps of lr 1e-4 the parameters may differ by up to ~6e-4.
TRAIN_RTOL = 1e-5  # losses
GRAD_RTOL = 1e-3
PARAM_ATOL = 1e-3


def phase_mesh_train(devices, batch: int = 16, patch: int = 64) -> None:
    """3 dp=4 train steps vs 3 one-card steps at the same global batch:
    gradients per step, losses, and the parameters after the last step."""
    import jax

    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.train.trainer import make_grad_fn, make_train_step

    batches = patch_batches(3, batch, patch, seed=20)
    meshes = (make_mesh(1, 1, devices=devices[:1]), make_mesh(len(devices), 1, devices=devices))
    results = []
    with jax.default_matmul_precision("highest"):
        grad_fns = [jax.jit(make_grad_fn(m)) for m in meshes]
        for mesh in meshes:
            step, opt_init = make_train_step(mesh)
            params = FM.init_params(0)
            opt = opt_init(params)
            losses, grads = [], []
            for img, lab in batches:
                # both meshes' gradients at the one-card trajectory
                if not results:
                    host = jax.tree_util.tree_map(np.asarray, params)
                    grads.append([jax.tree_util.tree_map(np.asarray, g(host, img, lab)[1])
                                  for g in grad_fns])
                params, opt, loss = step(params, opt, img, lab)
                losses.append(float(loss))
            results.append((np.asarray(losses), jax.tree_util.tree_map(np.asarray, params), grads))
    (l1, p1, grads), (l4, p4, _) = results
    worst_g = 0.0
    for g1, g4 in grads:
        for k in g1:
            err = float(np.max(np.abs(g4[k] - g1[k]))) / max(float(np.max(np.abs(g1[k]))), 1e-30)
            worst_g = max(worst_g, err)
    if worst_g > GRAD_RTOL:
        raise AssertionError(f"dp={len(devices)} gradients differ from one card by {worst_g:.3e} "
                             f"of the largest entry (limit {GRAD_RTOL})")
    np.testing.assert_allclose(l4, l1, rtol=TRAIN_RTOL)
    worst = max(float(np.max(np.abs(p4[k] - p1[k]))) for k in p1)
    if worst > PARAM_ATOL:
        raise AssertionError(f"dp={len(devices)} parameters after 3 steps differ from one card by "
                             f"{worst:.3e} (limit {PARAM_ATOL})")
    say(f"dp={len(devices)} vs one card, 3 train steps (precision=HIGHEST): gradients agree to "
        f"{worst_g:.3e} of each leaf's largest entry (limit {GRAD_RTOL}); losses "
        f"{' '.join(f'{v:.6f}' for v in l4)} agree to rtol {TRAIN_RTOL}; max |param diff| "
        f"{worst:.3e} (limit {PARAM_ATOL})")


# ---- main ------------------------------------------------------------------


def main(argv=None) -> int:
    global TAG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    import jax

    # the tests of phase 7 run in this process, on this platform
    jax.config.update("jax_platforms", "cuda")
    n = 4 if args.four_cards else 1
    devices = require_gpu(n)
    from qcnn_gpu.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    cards = query_cards()
    for line in cards[:n]:
        print(f"card: {line}", flush=True)
    TAG = "[" + ", ".join(parse_card_line(cards[0])) + "]"
    say(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")

    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            phase_mesh_engine(tmp, devices)
            phase_mesh_2d(devices)
            phase_mesh_train(devices)
        else:
            phase_cli(tmp, 1080, 1920, 8)
            phase_engine(tmp, devices[0])
            phase_forms(devices[0])
            phase_train()
            phase_gpu_tests()
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
