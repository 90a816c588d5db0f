"""Readers/writers for every reference binary model format + layout moves.

The reference passes weights through several layouts and file formats on the
way from the TF trainer to the CUDA engine (SURVEY.md §1 artifact flow):

  TF dump (float32 HWCN)                                model.py:318-340
    -> static qfp HWCN int8 file (hand-assembled)       qvrcnn.cu:535-556 input
    -> static qfp NCHW_VECT_C int8 file (engine)        qvrcnn.cu:558-585,
                                                        read by cnn.cu:90-112
  dynamic model files (stepw, w, b per layer)           cnn.cu:69-89
  plain float NCHW model files                          cnn.cu:113-128

The engine's in-memory layout is HWIO == the training-side "HWCN" (XLA
convs take NHWC/HWIO and hand cuDNN its own layouts), so HWCN files map to
in-memory arrays with zero shuffling, and NCHW_VECT_C exists purely for
byte-compatibility with the reference's engine files.

All integers little-endian; layer order C1, C2_1, C2_2, C3_1, C3_2, C4.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple, Union

import numpy as np

from qcnn_gpu.models.oracle import DynamicParams, EngineParams
from qcnn_gpu.models.topology import QVRCNN_LAYERS

PathOrIO = Union[str, BinaryIO]


def _open(path_or_fp: PathOrIO, mode: str):
    if isinstance(path_or_fp, str):
        return open(path_or_fp, mode), True
    return path_or_fp, False


def _warn_if_residual_zeroed(p: EngineParams, source: PathOrIO) -> EngineParams:
    """Warn when a static-qfp model's output-layer (mul, shift) zeroes the
    residual — the failure mode of the reference's stale QP22 table
    (QuantTable.last_row_stale). Model files carry no ratio/stepw to
    re-solve against, so the check is the direct one: even the LARGEST
    accumulator the layer can produce (all int8 inputs at +-127) requants
    to 0, meaning the engine provably restores nothing."""
    w4 = np.abs(np.asarray(p.weights[5], dtype=np.int64))
    u_max = int(w4.sum() * 127 + np.abs(np.asarray(p.biases[5], np.int64)).max())
    if (u_max * p.mul[5]) >> p.shift[5] == 0:
        import warnings

        name = source if isinstance(source, str) else getattr(source, "name", "<stream>")
        warnings.warn(
            f"{name}: output-layer requant (mul={p.mul[5]}, shift={p.shift[5]})"
            f" maps even the maximum accumulator {u_max} to residual 0 — the"
            " model restores nothing (stale quant table? see"
            " QuantTable.fixed_last_row)",
            stacklevel=3,
        )
    return p


# ---------------------------------------------------------------------------
# Layout converters (replacing mat.cu:97-196 — numpy, not per-element loops)
# ---------------------------------------------------------------------------


def _ceil4(c: int) -> int:
    return (c + 3) // 4 * 4


def hwcn_to_nchw_vect_c(w: np.ndarray) -> np.ndarray:
    """[H,W,C,N] -> [N, ceil(C/4), H, W, 4] with zero-padded channel tail.

    Matches HWCN2NCHW_VECT_C_CPU (mat.cu:97-119): output channel c lands in
    vector block c>>2, lane c&3.
    """
    h, wd, c, n = w.shape
    out = np.zeros((n, _ceil4(c) // 4, h, wd, 4), dtype=w.dtype)
    wt = np.moveaxis(w, (0, 1, 2, 3), (2, 3, 1, 0))  # [N,C,H,W]
    for c0 in range(c):
        out[:, c0 // 4, :, :, c0 % 4] = wt[:, c0]
    return out


def nchw_vect_c_to_hwcn(v: np.ndarray, c: int) -> np.ndarray:
    """Inverse of hwcn_to_nchw_vect_c; `c` is the true (unpadded) channels."""
    n, cblk, h, wd, four = v.shape
    assert four == 4 and cblk * 4 >= c
    out = np.zeros((h, wd, c, n), dtype=v.dtype)
    for c0 in range(c):
        out[:, :, c0, :] = np.moveaxis(v[:, c0 // 4, :, :, c0 % 4], 0, -1)
    return out


def hwcn_to_nchw(w: np.ndarray) -> np.ndarray:
    """[H,W,C,N] -> [N,C,H,W] (mat.cu:160-176)."""
    return np.moveaxis(w, (0, 1, 2, 3), (2, 3, 1, 0)).copy()


def nchw_to_hwcn(w: np.ndarray) -> np.ndarray:
    return np.moveaxis(w, (0, 1, 2, 3), (3, 2, 0, 1)).copy()


def hwcn_to_nhwc4(w: np.ndarray) -> np.ndarray:
    """[H,W,C,N] -> [N,H,W,ceil4(C)] channel-padded (mat.cu:177-196)."""
    h, wd, c, n = w.shape
    out = np.zeros((n, h, wd, _ceil4(c)), dtype=w.dtype)
    out[:, :, :, :c] = np.moveaxis(w, 3, 0)
    return out


# ---------------------------------------------------------------------------
# Static qfp formats (production engine parameters)
# ---------------------------------------------------------------------------


def read_static_qfp_hwcn(path: PathOrIO) -> EngineParams:
    """Per layer: w int8[k*k*cin*cout] HWCN, b int32[cout], blu, mul, shift
    (the file format consumed by model_qfp_HWCN2NCHW_VECT_C,
    qvrcnn.cu:535-556)."""
    fp, close = _open(path, "rb")
    try:
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            blu, mul, shift = struct.unpack("<3i", fp.read(12))
            ws.append(w.copy())
            bs.append(b)
            blus.append(blu)
            muls.append(mul)
            shifts.append(shift)
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


def write_static_qfp_hwcn(path: PathOrIO, p: EngineParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            fp.write(struct.pack("<3i", p.blu_q[i], p.mul[i], p.shift[i]))
    finally:
        if close:
            fp.close()


def read_static_qfp_vect_c(path: PathOrIO) -> EngineParams:
    """The engine-side NCHW_VECT_C static file (read by load_static_para,
    cnn.cu:90-112: w int8[k*k*ceil4(cin)*cout], b, blu, mul, shift)."""
    fp, close = _open(path, "rb")
    try:
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            nbytes = k * k * _ceil4(cin) * cout
            v = np.frombuffer(fp.read(nbytes), dtype=np.int8).reshape(
                cout, _ceil4(cin) // 4, k, k, 4
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            blu, mul, shift = struct.unpack("<3i", fp.read(12))
            ws.append(nchw_vect_c_to_hwcn(v, cin))
            bs.append(b)
            blus.append(blu)
            muls.append(mul)
            shifts.append(shift)
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


def write_static_qfp_vect_c(path: PathOrIO, p: EngineParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            v = hwcn_to_nchw_vect_c(np.asarray(p.weights[i], dtype=np.int8))
            fp.write(np.ascontiguousarray(v).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            fp.write(struct.pack("<3i", p.blu_q[i], p.mul[i], p.shift[i]))
    finally:
        if close:
            fp.close()


STATIC_QFP_PC_MAGIC = b"QFPC0001"


def write_static_qfp_pc(path: PathOrIO, p: EngineParams) -> None:
    """Per-CHANNEL static format (this framework's INT4 extension; no
    reference analog — the reference's formats carry one scalar
    (blu, mul, shift) triple per layer, qvrcnn.cu:535-556). Layout:
    8-byte magic, then per layer: w int8 HWCN, b int32[cout], blu
    int32[cout], mul int32[cout], shift int32[cout] (scalar rows are
    broadcast on write; single-valued rows collapse back to scalars on
    read, so scalar tables round-trip exactly)."""
    fp, close = _open(path, "wb")
    try:
        fp.write(STATIC_QFP_PC_MAGIC)
        for i, layer in enumerate(QVRCNN_LAYERS):
            cout = layer.out_ch
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            for v in (p.blu_q[i], p.mul[i], p.shift[i]):
                fp.write(
                    np.broadcast_to(np.asarray(v), (cout,)).astype("<i4").tobytes()
                )
    finally:
        if close:
            fp.close()


def read_static_qfp_auto(path: str) -> EngineParams:
    """Dispatch on the 8-byte magic: static-qfp-pc files (per-channel
    extension) vs the reference's headerless NCHW_VECT_C layout."""
    with open(path, "rb") as fp:
        magic = fp.read(8)
    if magic == STATIC_QFP_PC_MAGIC:
        return read_static_qfp_pc(path)
    return read_static_qfp_vect_c(path)


def read_static_qfp_pc(path: PathOrIO) -> EngineParams:
    fp, close = _open(path, "rb")
    try:
        magic = fp.read(8)
        if magic != STATIC_QFP_PC_MAGIC:
            raise ValueError(
                f"{path}: not a static-qfp-pc file (magic {magic!r})"
            )
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            rows = []
            for _ in range(3):
                v = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int64)
                rows.append(int(v[0]) if np.all(v == v[0]) else v)
            ws.append(w.copy())
            bs.append(b)
            blus.append(rows[0])
            muls.append(rows[1])
            shifts.append(rows[2])
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


# ---------------------------------------------------------------------------
# Dynamic model format (stepw, w, b per layer — cnn.cu:69-89)
# ---------------------------------------------------------------------------


def read_dynamic_hwcn(path: PathOrIO) -> DynamicParams:
    fp, close = _open(path, "rb")
    try:
        steps, ws, bs = [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            (stepw,) = struct.unpack("<i", fp.read(4))
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            steps.append(stepw)
            ws.append(w.copy())
            bs.append(b)
        return DynamicParams(steps, ws, bs)
    finally:
        if close:
            fp.close()


def write_dynamic_hwcn(path: PathOrIO, p: DynamicParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(struct.pack("<i", p.step_w[i]))
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
    finally:
        if close:
            fp.close()


def read_dynamic_vect_c(path: PathOrIO) -> DynamicParams:
    """Engine-side dynamic NCHW_VECT_C file: per layer [stepw i32]
    [w int8 k*k*ceil4(cin)*cout NCHW_VECT_C][b i32*cout] — written by
    layer_HWCN2NCHW_VECT_C (qvrcnn.cu:398-414: the leading int travels
    ahead of the converted weights) and read back by the INT8x4 engine's
    load_para (cnn.cu:69-89, whose built wSize is the VECT_C-padded one)."""
    fp, close = _open(path, "rb")
    try:
        steps, ws, bs = [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            (stepw,) = struct.unpack("<i", fp.read(4))
            nbytes = k * k * _ceil4(cin) * cout
            v = np.frombuffer(fp.read(nbytes), dtype=np.int8).reshape(
                cout, _ceil4(cin) // 4, k, k, 4
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            steps.append(stepw)
            ws.append(nchw_vect_c_to_hwcn(v, cin))
            bs.append(b)
        return DynamicParams(steps, ws, bs)
    finally:
        if close:
            fp.close()


def write_dynamic_vect_c(path: PathOrIO, p: DynamicParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(struct.pack("<i", p.step_w[i]))
            v = hwcn_to_nchw_vect_c(np.asarray(p.weights[i], dtype=np.int8))
            fp.write(np.ascontiguousarray(v).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
    finally:
        if close:
            fp.close()


# ---------------------------------------------------------------------------
# Float formats (TF dump — model.py:318-340; plain float engine files)
# ---------------------------------------------------------------------------


def read_float_hwcn(path: PathOrIO) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """TF `dump()` order: w1,b1,w2_1,b2_1,... raw float32, HWCN/HWIO."""
    fp, close = _open(path, "rb")
    try:
        ws, bs = [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(4 * k * k * cin * cout), dtype="<f4").reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<f4").astype(np.float32)
            ws.append(w.astype(np.float32))
            bs.append(b)
        return ws, bs
    finally:
        if close:
            fp.close()


def write_float_hwcn(path: PathOrIO, weights, biases) -> None:
    fp, close = _open(path, "wb")
    try:
        for w, b in zip(weights, biases):
            fp.write(np.asarray(w, dtype="<f4").tobytes())
            fp.write(np.asarray(b, dtype="<f4").tobytes())
    finally:
        if close:
            fp.close()


def read_float_nchw(path: PathOrIO) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Plain float NCHW engine file: per layer [w f32 NCHW][b f32*cout]
    (the FLOAT_CONFIG engine's load_para, cnn.cu:113-128; produced by
    model_HWCN2NCHW, qvrcnn.cu:444-463). Returned in HWCN/HWIO."""
    fp, close = _open(path, "rb")
    try:
        ws, bs = [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(4 * k * k * cin * cout), dtype="<f4").reshape(
                cout, cin, k, k
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<f4").astype(np.float32)
            ws.append(nchw_to_hwcn(w.astype(np.float32)))
            bs.append(b)
        return ws, bs
    finally:
        if close:
            fp.close()


def write_float_nchw(path: PathOrIO, weights, biases) -> None:
    fp, close = _open(path, "wb")
    try:
        for w, b in zip(weights, biases):
            fp.write(
                np.ascontiguousarray(
                    hwcn_to_nchw(np.asarray(w, dtype="<f4"))
                ).tobytes()
            )
            fp.write(np.asarray(b, dtype="<f4").tobytes())
    finally:
        if close:
            fp.close()


# ---------------------------------------------------------------------------
# Golden PSNR files (18 LE doubles — kernel.cu:112-115 pattern)
# ---------------------------------------------------------------------------


def read_psnr_goldens(path: str) -> np.ndarray:
    with open(path, "rb") as fp:
        data = fp.read()
    return np.frombuffer(data, dtype="<f8").copy()


def append_psnr_record(path: str, value: float) -> None:
    with open(path, "ab") as fp:
        fp.write(struct.pack("<d", float(value)))
