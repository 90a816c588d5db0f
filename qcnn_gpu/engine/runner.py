"""The inference engine runner — program cache, streaming, metrics.

Replaces the reference harness (`testqvrcnn`/`run_all`, kernel.cu:74-131):

  * one XLA program per QP (the platform's conv form, sharded over the
    engine's mesh if it has one), compiled once per geometry — like the
    reference reuses one built network per sequence but without per-layer
    descriptor plumbing. A program that fails to compile or run raises:
    nothing demotes to another path;
  * frames stream host->device in batches with the NEXT batch's transfer
    overlapped behind the current batch's compute (JAX async dispatch +
    explicit device_put ahead of wait) — replacing the synchronous
    per-frame cudaMemcpy loop (kernel.cu:91-97);
  * per-sequence metrics to the structured log (engine/metrics.py).

Timing matches the reference's definition: wall clock around the whole
frame loop INCLUDING host<->device transfers (kernel.cu:89-101).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from qcnn_gpu.data import yuv
from qcnn_gpu.data.model_files import (
    read_static_qfp_hwcn,
    read_static_qfp_vect_c,
)
from qcnn_gpu.engine.metrics import MetricsLog, RunRecord
from qcnn_gpu.models.oracle import EngineParams
from qcnn_gpu.models.qvrcnn import make_forward


class Engine:
    def __init__(
        self,
        impl: str = "auto",
        mesh=None,
        out_dir: str = ".",
        batch_frames: int = 4,
    ):
        self.impl = impl
        self.mesh = mesh
        self.batch_frames = batch_frames
        self.metrics = MetricsLog(out_dir)
        self._models: Dict[int, EngineParams] = {}
        self._programs: Dict[int, object] = {}  # qp -> compiled-on-call program
        self._duplex: Dict[Tuple, tuple] = {}  # (qp, geo, bs) -> transport
        # transport="auto" probe results: (qp, geo, bs) -> decision dict
        self.transport_decisions: Dict[Tuple, dict] = {}

    # ---- model management (load_static_para analog, qvrcnn.cu:47-63) ----
    def load_model(self, qp: int, path: str, fmt: str = "vect_c") -> None:
        import os

        if not os.path.exists(path):
            # "cannot open model file." (qvrcnn.cu:33-36), minus the exit(1)
            raise FileNotFoundError(f"cannot open model file: {path}")
        from qcnn_gpu.data.model_files import read_static_qfp_pc

        reader = {
            "vect_c": read_static_qfp_vect_c,
            "hwcn": read_static_qfp_hwcn,
            "pc": read_static_qfp_pc,  # per-channel INT4 extension
        }[fmt]
        self.set_model(qp, reader(path))

    def set_model(self, qp: int, params: EngineParams) -> None:
        """Install (or swap) the model for `qp`, dropping the programs and
        duplex transports built from the previous one."""
        self._models[qp] = params
        self._programs.pop(qp, None)
        self._duplex = {k: v for k, v in self._duplex.items() if k[0] != qp}

    def _program(self, qp: int):
        """The restoration program for `qp`: the XLA graph of the platform's
        conv form (models/qvrcnn.resolve_impl), sharded over the mesh when
        the engine has one. jax.jit compiles it once per geometry."""
        if qp not in self._programs:
            if qp not in self._models:
                raise KeyError(f"no model loaded for QP{qp}")
            if self.mesh is not None:
                from qcnn_gpu.parallel.spatial import make_sharded_forward

                run = make_sharded_forward(self._models[qp], self.mesh, impl=self.impl)
            else:
                run = make_forward(self._models[qp], impl=self.impl)
            self._programs[qp] = run
        return self._programs[qp]

    def _run(self, qp: int, frames):
        """Dispatch one batch; a failing program raises."""
        run = self._program(qp)
        self._last_impl = run.impl
        return run(frames)

    def profile_trace(self, trace_dir: str):
        """Context manager: capture a jax.profiler device trace of whatever
        runs inside (the device-side complement of the reference's
        QueryPerformanceCounter wall-clock bracketing, kernel.cu:89-101)."""
        import jax.profiler

        return jax.profiler.trace(trace_dir)

    # ---- restoration ----
    def restore(self, frames: np.ndarray, qp: int) -> np.ndarray:
        """uint8 [N, H, W] -> restored uint8 [N, H, W] (blocking)."""
        return np.asarray(self._run(qp, frames))

    def restore_stream(
        self, frames: np.ndarray, qp: int, depth: int = 3, transport: str = "raw"
    ) -> np.ndarray:
        """Pipelined streaming restore: `depth` batches in flight, with
        H2D of batch i+2, compute of batch i+1, and D2H of batch i all
        overlapped (engine/stream.py). transport="duplex" additionally
        packs BOTH copies (engine/packed.py: block-sparse temporal deltas
        up, nibble residuals down — bit-exact, ~4x fewer wire bytes on
        static-camera content); a failure of the packed path evicts its
        transport and raises. transport="auto" probes the LINK
        (sustained MB/s of a real H2D+D2H round trip) against the warm
        program's device rate and picks the duplex wire exactly when the
        raw transport could not keep the device fed (link-bound) — the
        per-(geometry, link-state) selection of VERDICT r4 #5; decisions
        are recorded in self.transport_decisions."""
        if transport == "auto":
            transport = self._pick_transport(frames, qp)
        if transport == "duplex":
            try:
                return self._restore_stream_duplex(frames, qp, depth)
            except BaseException:
                # the cached transport may now be DESYNCED (the producer can
                # run several send() calls past the receive() that raised,
                # advancing _prev/_carry without _res); reusing it would
                # decode silently wrong frames, so the next call starts clean
                self._evict_duplex(qp, frames.shape[-2:])
                raise
        from qcnn_gpu.engine.stream import pipeline_restore

        n = frames.shape[0]
        bs = self.batch_frames
        # device=None -> uncommitted placement, matching warmup()/restore()
        # numpy-input dispatch: a committed device_put here would key a
        # SECOND compile of the same program inside the streaming loop
        outs = pipeline_restore(
            lambda x: self._run(qp, x),
            (frames[i : i + bs] for i in range(0, n, bs)),
            depth=depth,
            device=None,
        )
        return np.concatenate(outs, axis=0)

    def _pick_transport(self, frames: np.ndarray, qp: int) -> str:
        """Measured raw-vs-duplex decision for THIS (geometry, link phase).

        Probe (a): sustained link MB/s via a jitted +1 round trip over one
        real batch (H2D + D2H of the actual bytes — the same definition as
        bench.py's in-window ceiling, just one-shot per stream).
        Probe (b): the device rate of the warm program on device-resident
        input. Raw keeps up iff link_fps >= ~device_fps; otherwise the
        stream is link-bound and the block-sparse duplex wire wins (its
        bytes/frame are content-dependent, so the decision is the
        conservative link-bound test rather than a duplex byte model).
        Decisions + measurements land in self.transport_decisions."""
        import time

        import jax

        bs = min(self.batch_frames, frames.shape[0])
        geo = tuple(frames.shape[-2:])
        key = (qp, geo, bs)
        if key in self.transport_decisions:
            return self.transport_decisions[key]["transport"]
        x = frames[:bs]
        bump = jax.jit(lambda a: a + 1)
        np.asarray(bump(x))  # compile + first transfer outside timing
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            np.asarray(bump(x))
            ts.append(time.perf_counter() - t0)
        link_mbps = 2 * x.nbytes / min(ts) / 1e6
        link_fps = link_mbps * 1e6 / (2 * x.nbytes / bs)
        run = self._program(qp)
        xd = jax.device_put(x)
        jax.block_until_ready(xd)
        jax.block_until_ready(run(xd))  # compile outside timing
        t0 = time.perf_counter()
        jax.block_until_ready(run(xd))
        dev_fps = bs / (time.perf_counter() - t0)
        choice = "duplex" if link_fps < 0.8 * dev_fps else "raw"
        self.transport_decisions[key] = {
            "transport": choice,
            "link_mbps": link_mbps,
            "link_fps": link_fps,
            "device_fps": dev_fps,
        }
        return choice

    def _evict_duplex(self, qp: int, geo) -> None:
        """Drop the cached duplex transport for (qp, geometry): called on
        any mid-stream failure, where producer/consumer state can be out
        of step (never reuse a possibly-desynced transport)."""
        self._duplex.pop((qp, tuple(geo), self.batch_frames), None)

    def _duplex_transport(self, qp: int, geo, bs: int):
        """Cached duplex-transport object for (qp, geometry, batch): the
        transport carries all stream state (host previous frame, residual
        carry, device carries) and its programs compile once — callers
        reuse it across restore_stream calls."""
        from qcnn_gpu.engine.packed import make_duplex_restore

        key = (qp, tuple(geo), bs)
        if key not in self._duplex:
            self._duplex[key] = make_duplex_restore(self._program(qp))
        return self._duplex[key]

    def _restore_stream_duplex(self, frames: np.ndarray, qp: int, depth: int):
        from qcnn_gpu.engine.packed import pipeline_restore_duplex

        n = frames.shape[0]
        bs = self.batch_frames
        geo = frames.shape[-2:]
        cut = (n // bs) * bs  # a ragged tail would force second step
        # compiles; it streams through the raw transport below instead
        transport = self._duplex_transport(qp, geo, bs)
        batches = [frames[i : i + bs] for i in range(0, cut, bs)]
        outs = pipeline_restore_duplex(transport, batches, depth=depth)
        self._last_impl = f"{self._program(qp).impl}+duplex"
        if cut < n:
            outs.append(np.asarray(self._run(qp, frames[cut:])))
        return np.concatenate(outs, axis=0)

    def warmup(
        self, qp: int, height: int, width: int, frames: int = 1,
        transport: str = "raw",
    ) -> None:
        """Compile EVERY program shape the streaming loop will dispatch,
        ahead of the timed region (a first compile takes seconds).
        restore_stream cuts `frames`
        into batch_frames-sized batches plus a ragged tail; both shapes
        must be warm or a compile lands inside run_sequence's timed span
        — the reference times the whole frame loop (kernel.cu:89-101),
        and a compile there inflates time_us by orders of magnitude."""
        bs = self.batch_frames
        sizes = {min(bs, max(frames, 1))}
        tail = frames % bs
        if frames > bs and tail:
            sizes.add(tail)
        for n in sorted(sizes):
            np.asarray(self._run(qp, np.zeros((n, height, width), np.uint8)))
        if transport == "duplex" and frames >= bs:
            tr = self._duplex_transport(qp, (height, width), bs)
            z = np.zeros((bs, height, width), np.uint8)
            try:
                for x in (z, z):  # full step, then the all-zero packed step
                    tr.receive(x, tr.send(x))
            except BaseException:
                # the half-warmed transport may hold advanced carries
                self._evict_duplex(qp, (height, width))
                raise

    # ---- the testqvrcnn analog (kernel.cu:74-116) ----
    def run_sequence(
        self,
        name: str,
        ori_path: str,
        anchor_path: str,
        height: int,
        width: int,
        qp: int,
        frames: int = 1,
        recon_path: Optional[str] = None,
        transport: str = "raw",
    ) -> RunRecord:
        ori = yuv.read_y(ori_path, height, width, frames)
        anchor = yuv.read_y(anchor_path, height, width, frames)
        self.warmup(qp, height, width, frames, transport=transport)

        t0 = time.perf_counter()
        recon = self.restore_stream(anchor, qp, transport=transport)
        time_us = int((time.perf_counter() - t0) * 1e6)

        rec = RunRecord(
            sequence=name,
            qp=qp,
            frames=frames,
            height=height,
            width=width,
            psnr_before=yuv.psnr(anchor, ori),
            psnr_after=yuv.psnr(recon, ori),
            time_us=time_us,
            # the impl that actually served the stream (re-calling _program
            # here without the geometry could key a fresh compile)
            impl=getattr(self, "_last_impl", self.impl),
            mesh="" if self.mesh is None else "x".join(map(str, self.mesh.devices.shape)),
        )
        self.metrics.append(rec)
        if recon_path:
            yuv.write_y_as_420(recon_path, recon)
        return rec

    def run_manifest(self, specs, data_root: str, qps=(22, 27, 32, 37), **kw):
        """The run_all analog: sweep sequences x QPs (kernel.cu:117-131)."""
        records = []
        for qp in qps:
            for s in specs:
                records.append(
                    self.run_sequence(
                        s.name,
                        s.ori_path(data_root),
                        s.anchor_path(data_root, qp),
                        s.height,
                        s.width,
                        qp,
                        frames=s.frames,
                        **kw,
                    )
                )
        return records
