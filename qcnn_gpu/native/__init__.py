"""Native (C++) host-side IO fast path — lazy-built, ctypes-bound.

`lib()` compiles qcnn_gpu/native/yuvio.cpp to a shared object on first
use (cached by source mtime under native/build/) and returns the ctypes
handle, or None when no toolchain is available — callers fall back to the
NumPy implementations in data/yuv.py, which define the semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "yuvio.cpp"), os.path.join(_DIR, "transport.cpp")]
_BUILD = os.path.join(_DIR, "build")
_SO = os.path.join(_BUILD, "libqcnnio.so")

_lib = None
_tried = False


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        os.makedirs(_BUILD, exist_ok=True)
        if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < max(
            os.path.getmtime(s) for s in _SRCS
        ):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", *_SRCS, "-o", _SO],
                check=True,
                capture_output=True,
            )
        h = ctypes.CDLL(_SO)
        h.read_y_planes.restype = ctypes.c_longlong
        h.read_y_planes.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ]
        h.write_y_as_420.restype = ctypes.c_int
        h.write_y_as_420.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong,
        ]
        h.sse_u8.restype = ctypes.c_double
        h.sse_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        h.psnr_u8.restype = ctypes.c_double
        h.psnr_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        h.preprocess_u8.restype = None
        h.preprocess_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        h.apply_residual_u8.restype = None
        h.apply_residual_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong
        ]
        h.duplex_classify.restype = None
        h.duplex_classify.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        h.duplex_fill.restype = None
        h.duplex_fill.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong
        ] + [ctypes.c_void_p] * 7
        h.residual_decode.restype = None
        h.residual_decode.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
        h.duplex_predict_tiles.restype = None
        h.duplex_predict_tiles.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong
        ] * 3 + [ctypes.c_void_p]
        h.duplex_predict_blocks.restype = None
        h.duplex_predict_blocks.argtypes = [ctypes.c_void_p] + [
            ctypes.c_longlong
        ] * 3 + [ctypes.c_void_p]
        h.duplex_decode8.restype = None
        h.duplex_decode8.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = h
    except Exception:
        _lib = None
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_y(path: str, height: int, width: int, frames: int, start: int = 0):
    """Native bulk Y-plane read -> uint8 [frames, H, W] or None."""
    h = lib()
    if h is None:
        return None
    out = np.empty((frames, height, width), dtype=np.uint8)
    got = h.read_y_planes(path.encode(), height, width, start, frames, _ptr(out))
    if got < 0:
        raise FileNotFoundError(path)
    if got < frames:
        raise EOFError(f"{path}: wanted {frames} frames, got {got} ({height}x{width})")
    return out


def write_y_as_420(path: str, y: np.ndarray) -> bool:
    h = lib()
    if h is None:
        return False
    y = np.ascontiguousarray(y, dtype=np.uint8)
    rc = h.write_y_as_420(path.encode(), _ptr(y), y.shape[0], y.shape[1], y.shape[2])
    if rc != 0:
        raise OSError(f"write failed: {path}")
    return True


def duplex_pack(x: np.ndarray, refs: np.ndarray, bucket_fn):
    """Native block-sparse temporal-delta pack (engine/packed.py
    semantics): ((nib_idx, nib, raw_idx, raw_val, idx, val), n_exc_total)
    or None without a toolchain. bucket_fn sizes the padded buffers."""
    h = lib()
    if h is None:
        return None
    n = x.size
    nb = -(-n // 256)
    xf = np.ascontiguousarray(x, dtype=np.uint8).reshape(-1)
    rf = np.ascontiguousarray(refs, dtype=np.uint8).reshape(-1)
    cls = np.empty(nb, np.uint8)
    counts = np.zeros(4, np.int64)
    h.duplex_classify(_ptr(xf), _ptr(rf), n, _ptr(cls), _ptr(counts))
    n_raw, n_nib, n_exc, n_exc_all = (int(v) for v in counts)
    kr, kn, ke = bucket_fn(n_raw), bucket_fn(n_nib), bucket_fn(n_exc)
    raw_idx = np.full(kr, nb, np.int32)
    raw_val = np.zeros((kr, 256), np.int8)
    nib_idx = np.full(kn, nb, np.int32)
    nib = np.zeros((kn, 128), np.uint8)
    idx = np.full(ke, nb * 256, np.int32)
    val = np.zeros(ke, np.int16)
    h.duplex_fill(
        _ptr(xf), _ptr(rf), n, _ptr(cls),
        _ptr(nib_idx), _ptr(nib), _ptr(raw_idx), _ptr(raw_val),
        _ptr(idx), _ptr(val),
    )
    return (nib_idx, nib, raw_idx, raw_val, idx, val), n_exc_all


def residual_decode(x_host: np.ndarray, nib: np.ndarray, idx: np.ndarray,
                    val: np.ndarray, n_exc: int):
    """Native packed-residual decode -> uint8 like x_host, or None."""
    h = lib()
    if h is None:
        return None
    b, hh, w = x_host.shape
    x = np.ascontiguousarray(x_host, dtype=np.uint8)
    nibc = np.ascontiguousarray(nib, dtype=np.uint8)
    idxc = np.ascontiguousarray(idx, dtype=np.int32)
    valc = np.ascontiguousarray(val, dtype=np.int16)
    out = np.empty_like(x)
    h.residual_decode(
        _ptr(x), _ptr(nibc), b * hh, w, _ptr(idxc), _ptr(valc), n_exc, _ptr(out)
    )
    return out


def duplex_predict(x: np.ndarray, refs: np.ndarray):
    """Native predicted-changed-block list (engine/packed.py
    _predict_changed_blocks semantics) -> (bidx i32 ascending, nb) or
    None. Dilation of the 8-px tile mask runs in NumPy (tiny grid)."""
    h = lib()
    if h is None:
        return None
    b, hh, w = x.shape
    ht, wt = -(-hh // 8), -(-w // 8)
    xc = np.ascontiguousarray(x, dtype=np.uint8)
    rc = np.ascontiguousarray(refs, dtype=np.uint8)
    tiles = np.zeros(b * ht * wt, np.uint8)
    h.duplex_predict_tiles(_ptr(xc), _ptr(rc), b, hh, w, _ptr(tiles))
    t = tiles.reshape(b, ht, wt).astype(bool)
    dil = t.copy()
    dil[:, 1:] |= t[:, :-1]
    dil[:, :-1] |= t[:, 1:]
    d2 = dil.copy()
    d2[:, :, 1:] |= dil[:, :, :-1]
    d2[:, :, :-1] |= dil[:, :, 1:]
    nb = -(-b * hh * w // 256)
    blk = np.zeros(nb, np.uint8)
    h.duplex_predict_blocks(
        _ptr(np.ascontiguousarray(d2.astype(np.uint8)).reshape(-1)),
        b, hh, w, _ptr(blk),
    )
    return np.nonzero(blk)[0].astype(np.int32), nb


def duplex_decode8(x: np.ndarray, rows: np.ndarray, bidx: np.ndarray,
                   nbp: int, prev_res: np.ndarray):
    """Native duplex receive decode (int8 rd blocks) -> (rec u8 [B,H,W],
    res_last i16 [1,H,W]) or None. Semantics defined by
    DuplexTransport.receive's NumPy path (engine/packed.py)."""
    h = lib()
    if h is None:
        return None
    b, hh, w = x.shape
    hw = hh * w
    xc = np.ascontiguousarray(x, dtype=np.uint8)
    rowsc = np.ascontiguousarray(rows, dtype=np.int8)
    bidxc = np.ascontiguousarray(bidx, dtype=np.int32)
    prevc = np.ascontiguousarray(prev_res.reshape(-1), dtype=np.int16)
    rec = np.empty_like(xc)
    res_last = np.empty(hw, np.int16)
    scratch = np.empty(b * hw, np.int16)
    h.duplex_decode8(
        _ptr(xc), b, hw, _ptr(rowsc), _ptr(bidxc), rowsc.shape[0], nbp,
        _ptr(prevc), _ptr(rec), _ptr(res_last), _ptr(scratch),
    )
    return rec, res_last.reshape(1, hh, w)


def psnr(a: np.ndarray, b: np.ndarray):
    h = lib()
    if h is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    assert a.size == b.size
    return float(h.psnr_u8(_ptr(a), _ptr(b), a.size))
