"""Device-mesh construction for the restoration engine.

The reference is single-process single-GPU (SURVEY.md §2.4); scale-out here
is a new component:

  dp — data parallel over frames (embarrassingly parallel; zero steady-state
       collectives, like the reference's per-frame loop, kernel.cu:91-97)
  sp — spatial parallel over frame rows with halo exchange (the mesh
       generalization of the reference's divided_run tiling,
       model.py:235-255)

The mesh is a plain ordering of the devices: the cards of one host are
joined all to all (NVLink), so no axis needs a particular neighbour.
Multi-host processes join via jax.distributed.initialize before
constructing the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def mesh_shape_for(
    n_devices: int,
    frames: Optional[int] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
):
    """Pick a mesh factorization: prefer pure DP (no collectives) when
    there are enough frames to keep every device busy; otherwise give the
    remainder to spatial sharding.

    Returns (dp, sp) — or (dp, sp, sw) when `cols` is given: the spatial
    factor splits over rows first (sp), then frame columns (sw, the 2-D
    generalization of the reference's 2x2 divided_run, model.py:235-255)
    once row shards would drop under 64 rows each. sw > 1 only when the
    column shards keep >= 128 px of width (halo still dwarfed)."""
    if frames is None or frames >= n_devices:
        return (n_devices, 1) if cols is None else (n_devices, 1, 1)
    dp = max(1, frames)
    while n_devices % dp:
        dp -= 1
    sp = n_devices // dp
    if rows is not None:
        # each spatial shard should carry enough rows to dwarf its halo
        while sp > 1 and rows // sp < 64:
            sp //= 2
    if cols is None:
        return (dp, sp)
    sw = 1
    spare = (n_devices // dp) // sp
    while spare > 1 and cols // (sw * 2) >= 128:
        sw *= 2
        spare //= 2
    return (dp, sp, sw)


def make_mesh(
    dp: int,
    sp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
    sw: int = 1,
) -> Mesh:
    """(dp, sp) mesh — or (dp, sp, sw) when sw > 1, adding the frame-
    column spatial axis for 2-D halo sharding."""
    devices = list(devices if devices is not None else jax.devices())
    need = dp * sp * sw
    if need > len(devices):
        raise ValueError(f"mesh {dp}x{sp}x{sw} needs {need} devices, have {len(devices)}")
    if sw == 1:
        arr = np.array(devices[:need]).reshape(dp, sp)
        return Mesh(arr, axis_names=("dp", "sp"))
    arr = np.array(devices[:need]).reshape(dp, sp, sw)
    return Mesh(arr, axis_names=("dp", "sp", "sw"))
