"""Multi-host process-group setup + frame-sharded distributed runs.

The reference has no distributed backend at all (SURVEY.md §2.4 P7); this
is a new component that replaces nothing and adds scale-out:

  * `initialize()` wraps jax.distributed.initialize — each host process
    joins the process group, then sees its local GPUs;
  * `global_mesh()` builds the (dp, sp) mesh over ALL devices of all
    processes; halo ppermutes and psums go to NCCL, and DP needs no
    steady-state collectives;
  * `DistributedRunner` shards a frame stream across hosts: each process
    feeds its addressable shard via make_array_from_process_local_data,
    restoration runs under the global program, PSNR reduces with psum.

Single-process multi-device works with the same code (initialize() is a
no-op when world_size == 1), which is how the tests exercise it on the
8-device virtual CPU mesh.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qcnn_gpu.models.oracle import EngineParams
from qcnn_gpu.parallel.mesh import make_mesh, mesh_shape_for
from qcnn_gpu.parallel.spatial import make_sharded_forward, psnr_sharded


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host process group. No-op for single-process runs;
    with explicit args (coordinator_address such as 'localhost:<port>',
    num_processes, process_id) this must be called before any jax
    computation on every host."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(frames_hint: Optional[int] = None, rows_hint: Optional[int] = None) -> Mesh:
    dp, sp = mesh_shape_for(len(jax.devices()), frames_hint, rows_hint)
    return make_mesh(dp, sp)


class DistributedRunner:
    """Frame-sharded restoration across every process/device in the slice."""

    def __init__(self, params: EngineParams, mesh: Optional[Mesh] = None, impl: str = "auto"):
        self.mesh = mesh if mesh is not None else global_mesh()
        self.run = make_sharded_forward(params, self.mesh, impl=impl)
        # (geometry, batch_frames) -> DuplexTransport over the SHARDED
        # program (carries + wire state live in the transport); keyed like
        # Engine._duplex so a shape change builds a fresh wire instead of
        # desyncing — and failure evicts only the failed key.
        self._duplex: dict = {}

    def _shard(self, frames: np.ndarray):
        spec = (
            P("dp", "sp", "sw") if "sw" in self.mesh.axis_names else P("dp", "sp", None)
        )
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(frames, sharding)
        # each process contributes its local slice of the global batch
        return jax.make_array_from_process_local_data(sharding, frames)

    def restore(self, frames: np.ndarray) -> np.ndarray:
        """frames: [N, H, W] uint8 (process-local shard when multi-host).
        Returns the GLOBAL restored batch on every process (single-process:
        a plain device fetch; multi-host: an all-gather across hosts — the
        'cross-host allgather of restored tiles' of the north star)."""
        out = self.run(self._shard(frames))
        if jax.process_count() == 1:
            return np.asarray(out)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(out, tiled=True))

    def restore_stream(
        self, frames: np.ndarray, depth: int = 3, transport: str = "raw",
        batch_frames: int = 0,
    ) -> np.ndarray:
        """Pipelined streaming restore over the MESH — the composition a
        multi-chip serving deployment runs: the block-sparse duplex wire
        (engine/packed.py) feeds the SHARDED program, so H2D ships
        temporal deltas, the mesh restores the batch (dp frames x sp/sw
        spatial shards, halo ppermutes over NCCL), and D2H returns the
        predicted-sparse residual deltas. transport='raw' streams plain
        frames through the same mesh program. Bit-exact either way; a
        duplex failure evicts that transport (it may be desynced) and
        raises.

        batch_frames defaults to the mesh's dp extent (every chip gets a
        frame per step).

        Multi-host limitation: the streaming path feeds the global numpy
        batch straight to the sharded program, which is only correct when
        this process owns every addressable shard — use restore() (which
        routes through make_array_from_process_local_data) from multi-host
        launches."""
        if jax.process_count() != 1:
            raise NotImplementedError(
                "restore_stream streams the GLOBAL batch from one process; "
                "multi-host launches must use restore() per local shard "
                f"(process_count={jax.process_count()})"
            )
        bs = batch_frames or max(self.mesh.shape.get("dp", 1), 1)
        n = frames.shape[0]
        key = (tuple(frames.shape[-2:]), bs)
        if transport == "duplex":
            try:
                from qcnn_gpu.engine.packed import (
                    make_duplex_restore,
                    pipeline_restore_duplex,
                )

                cut = (n // bs) * bs
                if key not in self._duplex:
                    self._duplex[key] = make_duplex_restore(
                        lambda x: self.run(self._shard_traced(x))
                    )
                batches = [frames[i : i + bs] for i in range(0, cut, bs)]
                outs = pipeline_restore_duplex(
                    self._duplex[key], batches, depth=depth
                )
                if cut < n:
                    outs.append(self._restore_padded(frames[cut:], bs))
                return np.concatenate(outs, axis=0)
            except BaseException:
                # never reuse a desynced transport; other keys stay valid
                self._duplex.pop(key, None)
                raise
        from qcnn_gpu.engine.stream import pipeline_restore

        cut = (n // bs) * bs
        outs = pipeline_restore(
            lambda x: self.run(x),
            (frames[i : i + bs] for i in range(0, cut, bs)),
            depth=depth,
            device=None,
        )
        if cut < n:
            outs.append(self._restore_padded(frames[cut:], bs))
        return np.concatenate(outs, axis=0)

    def _restore_padded(self, tail: np.ndarray, bs: int) -> np.ndarray:
        """Ragged-tail batches pad (edge-replicate) up to the mesh batch —
        the dp axis must divide the batch dim — then crop."""
        k = tail.shape[0]
        pad = np.concatenate([tail, np.repeat(tail[-1:], bs - k, axis=0)])
        return np.asarray(self.run(self._shard(pad)))[:k]

    def _shard_traced(self, x):
        """Inside the transport's jitted programs the batch arrives as a
        traced value — the sharded program's own with_sharding_constraint
        lays it out; nothing to do here (device_put is not traceable)."""
        return x

    def psnr(self, a: np.ndarray, ref: np.ndarray) -> float:
        """Distributed PSNR over the mesh (psum of per-device SSE)."""
        return float(psnr_sharded(a, ref, self.mesh))
