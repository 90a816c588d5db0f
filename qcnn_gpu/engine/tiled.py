"""Host-side halo-tiled restoration — one compile shape for any frame size.

The inference-engine generalization of the reference's training-side
`divided_run` (model.py:235-255), as an explicit library function: frames
are split into overlapping tiles, the tiles are batched through ONE
compiled program, and the overlap is cropped at stitch time. It bounds the
memory of one call (the CPU golden tests use it at 1080p and above); the
Engine itself never tiles.

Unlike `float_model.predict_uint8_tiled` (which mimics the reference's
ragged per-tile shapes — up to 9 distinct compiles), every tile here has
the SAME shape: each output tile's window is a fixed (tile_h+2*halo,
tile_w+2*halo) rectangle slid to stay INSIDE the frame, so border tiles
take their halo entirely from the interior instead of being clipped.
The whole frame costs exactly one compile + one dispatch.

Bit-exactness argument:
  * the network pads with zeros at EVERY layer (SAME pad, cnn.cu:44-49),
    so synthesizing input-domain frame-border halo is NOT exact (a
    zero-valued input region still yields bias-valued activations in
    deeper layers). Clamping the window inside the frame sidesteps this:
    wherever a window edge coincides with the frame edge, the tile
    program's own per-layer SAME padding is literally the whole-frame
    program's padding;
  * everywhere else the kept pixels are >= halo >= RECEPTIVE_RADIUS (6)
    real pixels from the window edge, so their full receptive field at
    every layer consists of exactly the values the whole-frame program
    computes (halo h covers layer depth: v1 exact >=2 rows in, v2 >=4,
    v3 >=5, v4/residual >=6).
Hence tiled output == whole-frame output on every pixel (tested in
tests/test_engine.py, including ragged grids).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from qcnn_gpu.models.topology import RECEPTIVE_RADIUS


def _windows(size: int, tile: int, win: int) -> List[Tuple[int, int, int]]:
    """Cover [0, size) with stride-`tile` output spans, each computed from
    a `win`-sized window clamped inside [0, size). Returns per-tile
    (window_start, crop_offset_in_window, kept_len)."""
    out = []
    for o0 in range(0, size, tile):
        keep = min(tile, size - o0)
        s = min(max(o0 - (win - keep) // 2, 0), size - win)
        # keep the kept span centered when possible, but always in-window
        s = min(max(s, o0 + keep - win), o0)
        out.append((s, o0 - s, keep))
    return out


def restore_tiled(
    run,
    frames: np.ndarray,
    tile_h: int = 540,
    tile_w: int = 960,
    halo: int = RECEPTIVE_RADIUS,
) -> np.ndarray:
    """Restore [N, H, W] uint8 frames through `run` (any whole-frame
    restoration program) by fixed-shape sliding-window tiling. Bit-exact
    vs running `run` on the whole frame (see module docstring)."""
    if halo < RECEPTIVE_RADIUS:
        raise ValueError(f"halo {halo} < receptive radius {RECEPTIVE_RADIUS}")
    frames = np.asarray(frames)
    n, h, w = frames.shape
    wh, ww = min(tile_h + 2 * halo, h), min(tile_w + 2 * halo, w)
    if wh == h and ww == w:
        return np.asarray(run(frames))
    # an axis no larger than its window is covered by one full-span tile
    rows = [(0, 0, h)] if wh == h else _windows(h, tile_h, wh)
    cols = [(0, 0, w)] if ww == w else _windows(w, tile_w, ww)
    tiles = np.empty((n, len(rows), len(cols), wh, ww), np.uint8)
    for i, (ys, _, _) in enumerate(rows):
        for j, (xs, _, _) in enumerate(cols):
            tiles[:, i, j] = frames[:, ys : ys + wh, xs : xs + ww]
    out = np.asarray(run(tiles.reshape(n * len(rows) * len(cols), wh, ww)))
    if out.dtype != np.uint8:  # fail loudly instead of silently truncating
        raise TypeError(f"restoration program returned {out.dtype}, expected uint8")
    out = out.reshape(n, len(rows), len(cols), wh, ww)
    result = np.empty((n, h, w), np.uint8)
    for i, (_, yc, yk) in enumerate(rows):
        y0 = i * tile_h
        for j, (_, xc, xk) in enumerate(cols):
            x0 = j * tile_w
            result[:, y0 : y0 + yk, x0 : x0 + xk] = out[
                :, i, j, yc : yc + yk, xc : xc + xk
            ]
    return result
