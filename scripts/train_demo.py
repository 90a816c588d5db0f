"""End-to-end loop demo: train float VRCNN -> calibrate -> quantize ->
restore with the INT8 engine, showing a real PSNR gain.

The reference repo ships no video data or float checkpoints, so its
psnr_static goldens cannot be reproduced number-for-number; this script
closes the loop the way the reference's own pipeline did (SURVEY.md §3.4-
§3.6) on synthetic codec-like degradation: 8x8 DCT coefficient
quantization (the actual mechanism of HEVC intra compression artifacts,
blocking + ringing included).

Artifacts written to --out-dir (default assets/demo):
    ckpt/              float checkpoint
    quant_table.data   solved fixed-point table (pickle)
    model_q.data       static-qfp NCHW_VECT_C engine model
    report.json        PSNR before / float-after / int8-after

    python scripts/train_demo.py --steps 1500
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.fft import dctn, idctn


def make_clean_frames(n, h, w, seed=0):
    """Natural-ish luma: smooth gradients + oriented textures + edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((n, h, w))
    for i in range(n):
        f1, f2 = rng.uniform(0.01, 0.1, 2)
        ph = rng.uniform(0, 6.28, 4)
        img = (
            120
            + 45 * np.sin(f1 * xx + ph[0]) * np.cos(f2 * yy + ph[1])
            + 30 * np.sin(0.5 * f2 * (xx + yy) + ph[2])
        )
        # hard edges (blocking shows strongly on these)
        for _ in range(6):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            val = rng.uniform(-50, 50)
            img[y0:, x0:] += val * 0.5
            img[: y0 // 2] -= val * 0.25
        img += rng.normal(0, 3, size=(h, w))
        out[i] = img
    return np.clip(out, 0, 255).astype(np.uint8)


def dct_compress(frames, q=28.0, seed=0):
    """8x8 block DCT quantization — codec-like degradation."""
    f = frames.astype(np.float64) - 128.0
    n, h, w = f.shape
    out = np.empty_like(f)
    for i in range(n):
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                blk = f[i, y : y + 8, x : x + 8]
                c = dctn(blk, norm="ortho")
                c = np.round(c / q) * q
                out[i, y : y + 8, x : x + 8] = idctn(c, norm="ortho")
    return np.clip(out + 128.0, 0, 255).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--finetune-steps", type=int, default=600)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--q", type=float, default=28.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out-dir", default="assets/demo")
    ap.add_argument("--qp", type=int, default=37)
    args = ap.parse_args()

    import jax

    from qcnn_gpu.data import yuv
    from qcnn_gpu.data.datasets import PatchDataset
    from qcnn_gpu.data.model_files import write_static_qfp_vect_c
    from qcnn_gpu.engine.calibrate import (
        calibrate_blu_bounds,
        quantize_model,
        solve_table,
    )
    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.train.trainer import TrainConfig, Trainer

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    print(f"generating {args.frames} frames {args.size}x{args.size} "
          f"+ DCT-q{args.q} anchors...", flush=True)
    clean = make_clean_frames(args.frames, args.size, args.size)
    anchor = dct_compress(clean, q=args.q)
    # held-out eval pair
    clean_ev = make_clean_frames(4, args.size, args.size, seed=99)
    anchor_ev = dct_compress(clean_ev, q=args.q, seed=99)
    base_psnr = yuv.psnr(anchor_ev, clean_ev)
    print(f"anchor PSNR (held-out): {base_psnr:.3f} dB", flush=True)

    ds = PatchDataset([(clean, anchor)], patch=64, seed=0)
    cfg = TrainConfig(lr=args.lr, batch_size=args.batch, log_every=200)
    tr = Trainer(cfg, mesh=make_mesh(1, 1))
    print(f"training {args.steps} steps...", flush=True)
    tr.fit_batches(
        ds.batches(args.batch, args.steps),
        metrics_path=os.path.join(args.out_dir, "train_metrics.jsonl"),
    )
    tr.save_checkpoint(os.path.join(args.out_dir, "ckpt"))

    pred_f = np.asarray(FM.predict_uint8(tr.params, anchor_ev))
    float_psnr = yuv.psnr(pred_f, clean_ev)
    print(f"float model PSNR: {float_psnr:.3f} dB (gain "
          f"{float_psnr - base_psnr:+.3f})", flush=True)

    # calibrate 3-sigma BLU bounds on training anchors, solve, quantize
    blu = calibrate_blu_bounds(tr.params, anchor[:4])
    table = solve_table(tr.params, blu_bounds=blu)
    table.save_pickle(os.path.join(args.out_dir, "quant_table.data"))
    ep = quantize_model(tr.params, table)
    write_static_qfp_vect_c(os.path.join(args.out_dir, "model_q.data"), ep)

    rec = O.forward_blu(anchor_ev, ep)
    int8_psnr = yuv.psnr(rec, clean_ev)
    print(f"INT8 engine PSNR: {int8_psnr:.3f} dB (gain "
          f"{int8_psnr - base_psnr:+.3f}, float->int8 loss "
          f"{float_psnr - int8_psnr:.3f})", flush=True)

    # shadow-weight quantization-aware fine-tune on the int8 grid
    # (model.py:170-233 flow) — recovers part of the float->int8 loss
    ft_psnr = None
    if args.finetune_steps:
        from qcnn_gpu.train.finetune import quant_finetune

        print(f"quant fine-tune {args.finetune_steps} steps...", flush=True)
        ft_params = quant_finetune(
            tr.params, table.stepw, tr.mesh,
            ds.batches(args.batch, args.finetune_steps),
            blu_ub=table.blu_adj, lr=args.lr * 0.1, log_every=200,
        )
        ep_ft = quantize_model(ft_params, table)
        write_static_qfp_vect_c(os.path.join(args.out_dir, "model_q_ft.data"), ep_ft)
        rec_ft = O.forward_blu(anchor_ev, ep_ft)
        ft_psnr = yuv.psnr(rec_ft, clean_ev)
        print(f"INT8 after fine-tune: {ft_psnr:.3f} dB (gain "
              f"{ft_psnr - base_psnr:+.3f}, recovered "
              f"{ft_psnr - int8_psnr:+.3f})", flush=True)

    report = {
        "anchor_psnr": base_psnr,
        "float_psnr": float_psnr,
        "int8_psnr": int8_psnr,
        "int8_finetuned_psnr": ft_psnr,
        "int8_gain_db": (ft_psnr if ft_psnr else int8_psnr) - base_psnr,
        "steps": args.steps,
        "backend": jax.default_backend(),
        "seconds": round(time.time() - t0, 1),
    }
    with open(os.path.join(args.out_dir, "report.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
