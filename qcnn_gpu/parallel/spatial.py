"""Halo-exchange spatial sharding — bit-exact tiled restoration on a mesh.

Mesh generalization of the reference's `divided_run` (model.py:235-255),
which splits frames >1500px into 2x2 overlapping tiles with a 10px halo
and crops at stitch time. Here the frame's row axis is sharded over the
mesh's `sp` axis; each device ppermutes its edge rows (RECEPTIVE_RADIUS=6,
the exact bound — the reference's 10 was conservative) to its neighbors
(NCCL between GPUs), runs the full conv pipeline on the halo-extended block, and
crops the halo from the result.

Bit-exactness argument:
  * exchange happens in the ppro domain (x-128), where the engine's SAME
    padding is literal zeros (cnn.cu:44-49 pad, applied after the -128
    shift, cnn.cu:449) — and lax.ppermute delivers zeros to devices with
    no source, so frame-boundary devices see exactly the unsharded pad;
  * every kept output row is >= 6 rows from the extended block's edge, so
    its full receptive field consists of correct rows.
Therefore sharded output == unsharded output on every pixel (tested on the
8-device CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qcnn_gpu.models.oracle import EngineParams
from qcnn_gpu.models.qvrcnn import (
    MergedParams,
    ModelParams,
    residual_blu_merged,
    resolve_impl,
)
from qcnn_gpu.models.topology import RECEPTIVE_RADIUS
from qcnn_gpu.ops.requant import apply_residual_u8


def _halo_exchange(x: jnp.ndarray, axis_name: str, halo: int, dim: int) -> jnp.ndarray:
    """Extend array dimension `dim` with `halo` slices from each neighbor
    along mesh axis `axis_name`. Missing neighbors (frame boundary) yield
    zeros — matching SAME zero padding in the ppro domain."""
    n = lax.axis_size(axis_name)
    if n == 1:
        pad = [(0, 0)] * x.ndim
        pad[dim] = (halo, halo)
        return jnp.pad(x, pad)
    lo = [slice(None)] * x.ndim
    hi = [slice(None)] * x.ndim
    lo[dim] = slice(None, halo)
    hi[dim] = slice(-halo, None)
    down = [(i, i + 1) for i in range(n - 1)]  # shard i sends to i+1
    up = [(i + 1, i) for i in range(n - 1)]  # shard i+1 sends to i
    from_before = lax.ppermute(x[tuple(hi)], axis_name, down)
    from_after = lax.ppermute(x[tuple(lo)], axis_name, up)
    return jnp.concatenate([from_before, x, from_after], axis=dim)


def halo_exchange_rows(x: jnp.ndarray, axis_name: str, halo: int) -> jnp.ndarray:
    """Extend a [N, H_local, ...] block with `halo` rows from each
    row-neighbor (see _halo_exchange)."""
    return _halo_exchange(x, axis_name, halo, dim=1)


def halo_exchange_cols(x: jnp.ndarray, axis_name: str, halo: int) -> jnp.ndarray:
    """Extend a [N, H, W_local, ...] block with `halo` columns from each
    column-neighbor. Corner fill: exchanging columns AFTER rows is
    sufficient — the column neighbor has already row-extended its block,
    so its edge columns carry the DIAGONAL neighbor's corner pixels
    (every device runs the same SPMD program, so the ordering holds
    globally)."""
    return _halo_exchange(x, axis_name, halo, dim=2)


def make_sharded_forward(
    p: EngineParams,
    mesh: Mesh,
    impl: str = "auto",
    halo: int = RECEPTIVE_RADIUS,
):
    """Jitted fn(uint8 [N, H, W]) -> uint8 [N, H, W] over a (dp, sp) mesh.

    N must divide by mesh dp, H by mesh sp. Weights are replicated (54.5k
    parameters — broadcast once, like the engine's one-time load_para H2D,
    cnn.cu:105-106).

    impl: the conv form ('int', 'bf16', or 'auto', which is 'int';
    models/qvrcnn.resolve_impl) of the XLA graph run inside each shard.

    A mesh with an 'sw' axis (make_mesh(dp, sp, sw=...)) shards frame
    COLUMNS too — the full 2-D generalization of the reference's 2x2
    divided_run (model.py:235-255): halos ppermute along both axes (rows
    first, then columns, which fills the diagonal corners), and the valid
    masks carry the 2-D frame edge.
    """
    two_d = "sw" in mesh.axis_names

    def _bounds(axis_name, extent):
        """(lo, hi) valid range inside a halo-extended block along a mesh
        axis: frame-boundary shards see the halo as outside-frame."""
        idx = lax.axis_index(axis_name)
        n = lax.axis_size(axis_name)
        lo = jnp.where(idx == 0, halo, 0)
        hi = jnp.where(idx == n - 1, extent - halo, extent)
        return lo, hi

    mp = ModelParams.from_engine(p)
    chosen = resolve_impl(impl, mp)
    mpar = MergedParams.from_engine(p)

    def block_fn(xb):  # xb: [N/dp, H/sp, W/sw] uint8
        xe = xb[..., None].astype(jnp.int32) - 128
        xe = halo_exchange_rows(xe, "sp", halo)
        if two_d:
            xe = halo_exchange_cols(xe, "sw", halo)
        # Frame-boundary shards: halo rows/cols lie OUTSIDE the frame
        # and must act as per-layer zero padding (residual_blu
        # row_valid docstring).
        row_lo, row_hi = _bounds("sp", xe.shape[1])
        row = jnp.arange(xe.shape[1])
        row_valid = (row >= row_lo) & (row < row_hi)
        col_valid = None
        if two_d:
            col_lo, col_hi = _bounds("sw", xe.shape[2])
            col = jnp.arange(xe.shape[2])
            col_valid = (col >= col_lo) & (col < col_hi)
        res = residual_blu_merged(
            xe, mpar, chosen, row_valid=row_valid, col_valid=col_valid
        )
        if two_d:
            res = res[:, halo:-halo, halo:-halo]
        else:
            res = res[:, halo:-halo]
        return apply_residual_u8(xb, res)

    spec = P("dp", "sp", "sw") if two_d else P("dp", "sp", None)
    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=spec,
        out_specs=spec,
        check_vma=False,
    )

    in_sharding = NamedSharding(mesh, spec)

    @jax.jit
    def run(x_uint8):
        x_uint8 = jax.lax.with_sharding_constraint(x_uint8, in_sharding)
        return sharded(x_uint8)

    run.mesh = mesh
    run.impl = chosen
    run.in_sharding = in_sharding
    return run


def psnr_sharded(a_uint8, ref_uint8, mesh: Mesh):
    """Distributed PSNR: per-device partial SSE + psum over the mesh —
    the collective replacing the host-side double loop (yuv_data.cpp:87-97).

    Matches the reference's double-precision accumulation exactly: squared
    diffs are integers <= 65025, so an int-valued f64 sum is exact up to
    2^53 (~10^8 4K frames); computed under a local x64 scope because this
    environment keeps jax in f32-by-default."""
    with jax.enable_x64(True):

        axes = tuple(mesh.axis_names)

        def block(a, r):
            d = a.astype(jnp.float64) - r.astype(jnp.float64)
            sse = jnp.sum(d * d)
            for ax in axes:
                sse = lax.psum(sse, ax)
            return sse[None]

        spec = (
            P("dp", "sp", "sw") if "sw" in mesh.axis_names else P("dp", "sp", None)
        )
        f = jax.shard_map(
            block,
            mesh=mesh,
            in_specs=(spec, spec),
            out_specs=P(None),
            check_vma=False,
        )
        sse = float(f(a_uint8, ref_uint8)[0])
    n = a_uint8.size
    mse = sse / n
    import math

    return 10.0 * math.log10(65025.0 / mse)
