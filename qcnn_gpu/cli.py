"""Command-line interface — the process entry replacing kernel.cu's main
and training/main.py's tf.app.flags in one place.

    python -m qcnn_gpu.cli run      --ori ori.yuv --anchor anchor.yuv \
        --height 240 --width 416 --model model_q37.data --qp 37
    python -m qcnn_gpu.cli sweep    --data-root /data --qps 22,27,32,37
    python -m qcnn_gpu.cli convert  --infile m.hwcn --informat hwcn \
        --outfile m.vectc --outformat vect_c
    python -m qcnn_gpu.cli train    --ori o.yuv --anchor a.yuv ...
    python -m qcnn_gpu.cli finetune --ckpt dir --qp 37 ...
    python -m qcnn_gpu.cli calibrate --ckpt dir --qp 37 --out table.data
    python -m qcnn_gpu.cli bench
"""

from __future__ import annotations

import argparse
import sys


def _add_geometry(p):
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--frames", type=int, default=1)


def cmd_run(args) -> int:
    from qcnn_gpu.engine.runner import Engine

    if args.config:
        from qcnn_gpu.config import Config

        eng = Config.load(args.config).make_engine()
    else:
        mesh = None
        if args.mesh:
            from qcnn_gpu.parallel.mesh import make_mesh

            dims = [int(v) for v in args.mesh.split("x")]
            if len(dims) not in (1, 2, 3):
                raise SystemExit(
                    f"--mesh {args.mesh!r}: expected DPxSP[xSW] with 1-3 "
                    f"'x'-separated dims, got {len(dims)}"
                )
            dp, sp = dims[0], dims[1] if len(dims) > 1 else 1
            mesh = make_mesh(dp, sp, sw=dims[2] if len(dims) > 2 else 1)
        eng = Engine(impl=args.impl, mesh=mesh, out_dir=args.out_dir)
    eng.load_model(args.qp, args.model, fmt=args.model_format)
    rec = eng.run_sequence(
        name=args.anchor,
        ori_path=args.ori,
        anchor_path=args.anchor,
        height=args.height,
        width=args.width,
        qp=args.qp,
        frames=args.frames,
        recon_path=args.recon,
        transport=args.transport,
    )
    print(
        f"before net: PSNR={rec.psnr_before:.3f}\n"
        f"after quantized net: PSNR={rec.psnr_after:.3f}\n"
        f"time: {rec.time_us}us ({rec.fps:.1f} fps, impl={rec.impl})"
    )
    return 0


def cmd_sweep(args) -> int:
    from qcnn_gpu.data.manifest import JCTVC_SEQUENCES, load_manifest
    from qcnn_gpu.engine.runner import Engine

    specs = load_manifest(args.manifest) if args.manifest else JCTVC_SEQUENCES
    eng = Engine(impl=args.impl, out_dir=args.out_dir)
    for qp in (int(q) for q in args.qps.split(",")):
        eng.load_model(qp, args.model_pattern % qp, fmt=args.model_format)
    records = eng.run_manifest(
        specs, args.data_root, qps=[int(q) for q in args.qps.split(",")],
        transport=args.transport,
    )
    for r in records:
        print(f"{r.sequence} QP{r.qp}: {r.psnr_before:.3f} -> {r.psnr_after:.3f} dB, {r.fps:.1f} fps")
    return 0


CONVERT_FORMATS = {
    # family -> {format: (reader, writer)}; conversion is legal within a
    # family (the reference's model_* converters, qvrcnn.cu:398-585:
    # static qfp, dynamic, and float each travel in their own pair of
    # layouts — HWCN training-side, NCHW[_VECT_C] engine-side)
    "static": {
        "hwcn": ("read_static_qfp_hwcn", "write_static_qfp_hwcn"),
        "vect_c": ("read_static_qfp_vect_c", "write_static_qfp_vect_c"),
        # per-channel INT4 extension (write collapses scalar rows exactly,
        # so static tables convert losslessly INTO pc; pc -> scalar formats
        # is only legal when every row is single-valued)
        "pc": ("read_static_qfp_pc", "write_static_qfp_pc"),
    },
    "dynamic": {
        "dyn_hwcn": ("read_dynamic_hwcn", "write_dynamic_hwcn"),
        "dyn_vect_c": ("read_dynamic_vect_c", "write_dynamic_vect_c"),
    },
    "float": {
        "float_hwcn": ("read_float_hwcn", "write_float_hwcn"),
        "float_nchw": ("read_float_nchw", "write_float_nchw"),
    },
}
_ALL_FORMATS = [f for fam in CONVERT_FORMATS.values() for f in fam]
IMPLS = ["auto", "bf16", "int"]


def cmd_convert(args) -> int:
    from qcnn_gpu.data import model_files as MF

    fam_in = next(f for f, d in CONVERT_FORMATS.items() if args.informat in d)
    fam_out = next(f for f, d in CONVERT_FORMATS.items() if args.outformat in d)
    if fam_in != fam_out:
        print(
            f"error: cannot convert {args.informat} ({fam_in} family) to "
            f"{args.outformat} ({fam_out} family); pick formats from one family"
        )
        return 2
    reader = getattr(MF, CONVERT_FORMATS[fam_in][args.informat][0])
    writer = getattr(MF, CONVERT_FORMATS[fam_out][args.outformat][1])
    params = reader(args.infile)
    if fam_in == "float":  # float readers return (weights, biases)
        writer(args.outfile, *params)
    else:
        writer(args.outfile, params)
    print(f"converted {args.infile} ({args.informat}) -> {args.outfile} ({args.outformat})")
    return 0


def cmd_train(args) -> int:
    import jax

    from qcnn_gpu.data.datasets import PatchDataset, PrefetchLoader
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.quant.solver import BLU_INIT
    from qcnn_gpu.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        qp=args.qp, blu=args.blu, lr=args.lr, batch_size=args.batch_size,
        epochs=args.epochs, seed=args.seed,
    )
    ds = PatchDataset.from_yuv(
        [(args.ori, args.anchor, args.height, args.width)],
        frames=args.frames, patch=cfg.patch, seed=cfg.seed,
    )
    mesh = make_mesh(len(jax.devices()), 1)
    blu_ub = BLU_INIT[args.qp] if args.blu else None
    tr = Trainer(cfg, mesh=mesh, blu_ub=blu_ub)
    if args.resume:
        tr.load_checkpoint(args.ckpt)
    steps = args.steps or (ds.pieces // cfg.batch_size) * cfg.epochs
    tr.fit_batches(
        PrefetchLoader(ds.batches(cfg.batch_size, steps)),
        image_dir=args.image_dir,
    )
    tr.save_checkpoint(args.ckpt)
    print(f"trained {steps} steps -> {args.ckpt}")
    return 0


def cmd_calibrate(args) -> int:
    import numpy as np

    from qcnn_gpu.data import yuv
    from qcnn_gpu.data.model_files import (
        write_static_qfp_hwcn,
        write_static_qfp_pc,
        write_static_qfp_vect_c,
    )
    from qcnn_gpu.engine.calibrate import calibrate_blu_bounds, quantize_model, solve_table
    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.train.checkpoint import load_checkpoint
    import optax

    params_t = FM.init_params(0)
    opt_t = optax.adam(1e-4).init(params_t)
    params, _, _ = load_checkpoint(args.ckpt, params_t, opt_t)
    if args.sample:
        sample = yuv.read_y(args.sample, args.height, args.width, args.frames)
        blu = calibrate_blu_bounds(params, sample)
    else:
        blu = None
    per_channel = getattr(args, "per_channel", False) or args.model_format == "pc"
    table = solve_table(params, blu_bounds=blu, qp=args.qp, wbits=args.wbits,
                        per_channel=per_channel)
    if not per_channel:
        table.save_pickle(args.table_out)
    ep = quantize_model(params, table, wbits=args.wbits)
    if args.model_out:
        if per_channel:
            write_static_qfp_pc(args.model_out, ep)
        elif args.model_format == "vect_c":
            write_static_qfp_vect_c(args.model_out, ep)
        else:
            write_static_qfp_hwcn(args.model_out, ep)
    msgs = [] if per_channel else [f"table -> {args.table_out}"]
    if args.model_out:
        msgs.append(f"model -> {args.model_out}")
    print(", ".join(msgs) or "per-channel table solved (model-out not given)")
    return 0


def cmd_finetune(args) -> int:
    """Shadow-weight quantization-aware fine-tune (model.py:170-233):
    load a float checkpoint + its per-QP table, fine-tune on the int8
    grid, save the grid checkpoint + optionally the engine model file."""
    import jax
    import numpy as np
    import optax

    from qcnn_gpu.data.datasets import PatchDataset, PrefetchLoader
    from qcnn_gpu.data.model_files import write_static_qfp_vect_c
    from qcnn_gpu.engine.calibrate import quantize_model
    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.quant.params import QuantTable
    from qcnn_gpu.quant.solver import BLU_INIT
    from qcnn_gpu.train.checkpoint import load_checkpoint, save_checkpoint
    from qcnn_gpu.train.finetune import quant_finetune

    params_t = FM.init_params(0)
    opt_t = optax.adam(args.lr).init(params_t)
    params, _, step0 = load_checkpoint(args.ckpt, params_t, opt_t)
    table = QuantTable.load_pickle(args.table)
    ds = PatchDataset.from_yuv(
        [(args.ori, args.anchor, args.height, args.width)],
        frames=args.frames, seed=0,
    )
    mesh = make_mesh(len(jax.devices()), 1)
    steps = args.steps or ds.pieces // args.batch_size
    out = quant_finetune(
        params, table.stepw, mesh,
        PrefetchLoader(ds.batches(args.batch_size, steps)),
        blu_ub=BLU_INIT[args.qp], lr=args.lr,
    )
    save_checkpoint(args.ckpt + "_qfp", out, opt_t, step0 + steps)
    if args.model_out:
        ep = quantize_model(out, table)
        write_static_qfp_vect_c(args.model_out, ep)
    print(f"finetuned {steps} steps -> {args.ckpt}_qfp"
          + (f", model -> {args.model_out}" if args.model_out else ""))
    return 0


def cmd_eval_float(args) -> int:
    """Float-model evaluation over a sequence — the test() analog
    (model.py:257-297): per-sequence PSNR before/after, binary psnr.data +
    psnr_ori.data records."""
    import os

    import numpy as np
    import optax

    from qcnn_gpu.data import yuv
    from qcnn_gpu.data.model_files import append_psnr_record
    from qcnn_gpu.models import float_model as FM
    from qcnn_gpu.quant.solver import BLU_INIT
    from qcnn_gpu.train.checkpoint import load_checkpoint

    params_t = FM.init_params(0)
    opt_t = optax.adam(1e-4).init(params_t)
    params, _, _ = load_checkpoint(args.ckpt, params_t, opt_t)
    ori = yuv.read_y(args.ori, args.height, args.width, args.frames)
    anchor = yuv.read_y(args.anchor, args.height, args.width, args.frames)
    blu_ub = BLU_INIT[args.qp] if args.blu else None
    pred = np.asarray(FM.predict_uint8(params, anchor, blu_ub))
    p_before = yuv.psnr(anchor, ori)
    p_after = yuv.psnr(pred, ori)
    append_psnr_record(os.path.join(args.out_dir, "psnr.data"), p_after)
    append_psnr_record(os.path.join(args.out_dir, "psnr_ori.data"), p_before)
    print(f"PSNR: before net {p_before:.3f}\tafter net {p_after:.3f}")
    return 0


def cmd_validate(args) -> int:
    """Cross-implementation validation report (conv_validation + viewmem
    analogs) on synthetic or provided frames."""
    from qcnn_gpu.data import model_files, yuv
    from qcnn_gpu.engine import validate as V
    from qcnn_gpu.testing import synth_frames

    p = model_files.read_static_qfp_vect_c(args.model) if args.model_format == "vect_c" else model_files.read_static_qfp_hwcn(args.model)
    if args.anchor:
        frames = yuv.read_y(args.anchor, args.height, args.width, args.frames)
    else:
        frames = synth_frames(1, 64, 96, seed=0)
    print(V.viewmem_report(p, frames[:1]))
    if args.dump_features:
        V.dump_features(p, frames[:1], args.dump_features)
        print(f"feature maps -> {args.dump_features}")
    return 0


def cmd_calibrate_dynamic(args) -> int:
    """Run the dynamic-quantization path on device, recording max_u
    telemetry (the save_steps flow, qvrcnn.cu:70-81,163). --mode hybrid
    runs the committed hybrid forward() instead (qvrcnn.cu:82-167: static
    C1 mul_shift with int8 wrap, BLU concats, hardcoded 141/16 output).
    --b-adj-out appends per-frame adjusted-bias telemetry
    (save_b_adj analog, qvrcnn.cu:288-304; dynamic mode only)."""
    import struct

    from qcnn_gpu.data import model_files, yuv

    frames = yuv.read_y(args.anchor, args.height, args.width, args.frames)

    if args.mode == "hybrid":
        from qcnn_gpu.models.qvrcnn_dynamic import make_hybrid_forward

        ep = (
            model_files.read_static_qfp_vect_c(args.model)
            if args.model_format == "vect_c"
            else model_files.read_static_qfp_hwcn(args.model)
        )
        run = make_hybrid_forward(ep)
        max_c1 = 0
        for i in range(frames.shape[0]):
            _, max_u = run(frames[i : i + 1])
            max_c1 = max(max_c1, int(max_u))
            with open(args.out, "ab") as fp:
                fp.write(struct.pack("<i", int(max_u)))  # max_u_C1.data format
        print("hybrid max_u_C1:", max_c1, "->", args.out)
        return 0

    from qcnn_gpu.engine.calibrate import save_b_adj
    from qcnn_gpu.models.qvrcnn_dynamic import make_dynamic_forward

    p = model_files.read_dynamic_hwcn(args.model)
    run = make_dynamic_forward(p)
    maxima = [0, 0, 0]
    for i in range(frames.shape[0]):
        _, tel = run(frames[i : i + 1])
        groups = [
            int(tel["max_u"][0]),
            max(int(v) for v in tel["max_u"][1]),
            max(int(v) for v in tel["max_u"][2]),
        ]
        maxima = [max(a, b) for a, b in zip(maxima, groups)]
        with open(args.out, "ab") as fp:
            fp.write(struct.pack("<i", groups[0]))  # max_u_C1.data format
        if args.b_adj_out:
            save_b_adj(args.b_adj_out, [v for v in tel["b_adj"]])
    print("per-group max_u:", maxima, "->", args.out)
    return 0


def cmd_bench(args) -> int:
    import bench

    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qcnn_gpu", description=__doc__)
    ap.add_argument(
        "--platform",
        default=None,
        help="force a jax platform (e.g. cpu or cuda)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="restore one sequence (testqvrcnn analog)")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--model", required=True)
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--qp", type=int, required=True)
    p.add_argument(
        "--impl",
        default="auto",
        choices=IMPLS,
        help="conv form; auto = the platform's measured choice",
    )
    p.add_argument("--config", default=None, help="JSON Config file (overrides flags)")
    p.add_argument("--mesh", default="",
                   help="dpxsp[xsw], e.g. 2x4 or 1x2x4 (sw = frame-column "
                        "spatial axis, 2-D halo sharding)")
    p.add_argument("--recon", default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument(
        "--transport",
        default="raw",
        choices=["raw", "duplex", "auto"],
        help="duplex = block-sparse temporal-delta H2D + packed-residual "
        "D2H (bit-exact; ~4x fewer wire bytes on static-camera content)",
    )
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="run the JCT-VC manifest (run_all analog)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--model-pattern", required=True, help="e.g. models/q%%d.data")
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--qps", default="22,27,32,37")
    p.add_argument("--manifest", default=None)
    p.add_argument("--impl", default="auto", choices=IMPLS)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--transport", default="raw", choices=["raw", "duplex", "auto"])
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("convert", help="model file format conversion")
    p.add_argument("--infile", required=True)
    p.add_argument("--informat", required=True, choices=_ALL_FORMATS)
    p.add_argument("--outfile", required=True)
    p.add_argument("--outformat", required=True, choices=_ALL_FORMATS)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("train", help="float training")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--blu", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default="checkpoint")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--image-dir", default=None,
                   help="dump input|output|target triplet PNGs at log steps "
                        "(tf.summary.image analog, model.py:61-69)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("calibrate", help="solve quant table from a checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--sample", default=None, help="YUV file for 3-sigma BLU stats")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--table-out", default="quant_table.data")
    p.add_argument("--model-out", default=None)
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--wbits", type=int, default=8, choices=[4, 8],
                   help="weight grid: 8 (reference) or 4 (INT4 stretch)")
    p.add_argument("--per-channel", action="store_true",
                   help="per-output-channel stepw + (mul, shift) (INT4 "
                        "quality closure); model file lands in the 'pc' "
                        "format")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("finetune", help="shadow-weight quant-aware fine-tune")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--table", required=True, help="quant_params pickle")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--model-out", default=None)
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("eval-float", help="float-model sequence eval (test() analog)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--blu", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_eval_float)

    p = sub.add_parser("validate", help="cross-impl validation report (viewmem analog)")
    p.add_argument("--model", required=True)
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--anchor", default=None)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--dump-features", default=None)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser(
        "calibrate-dynamic", help="dynamic-path max_u telemetry (save_steps analog)"
    )
    p.add_argument("--model", required=True, help="dynamic-format model file (static qfp for --mode hybrid)")
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"],
                   help="static-qfp container for --mode hybrid")
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--out", default="max_u_C1.data")
    p.add_argument("--mode", choices=["dynamic", "hybrid"], default="dynamic")
    p.add_argument("--b-adj-out", default=None, help="append save_b_adj telemetry here")
    p.set_defaults(fn=cmd_calibrate_dynamic)

    p = sub.add_parser("bench", help="headline benchmark")
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from qcnn_gpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        return args.fn(args)
    except (FileNotFoundError, EOFError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
