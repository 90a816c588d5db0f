"""Packed wire transports for link-bound streaming (bit-exact).

The reference's timing definition includes both host<->device copies
(kernel.cu:89-101). When the link — not the device — bounds throughput (a
thin PCIe share, remote serving over a network), the raw
round trip moves 2 B/px: anchor up, recon down. Both directions are
redundant:

* D2H (make_packed_restore): the restoration residual rec − x is a
  low-entropy signal (a sub-1-dB correction, overwhelmingly within ±7)
  — ship 4-bit nibbles + an EXACT exception list; ~0.53 B/px.
* duplex (DuplexTransport): successive decoded-video frames are
  temporally redundant AND the restorer is a deterministic per-frame
  conv net with a 6-px receptive radius — ship block-sparse temporal
  deltas up and fetch only the PREDICTABLY-changed residual-delta
  blocks down; ~0.1-0.3 B/px each way on static-camera content, with
  measured per-batch byte/stage accounting in `stats`.

Every path is lossless by construction: content the formats cannot beat
raw bytes on ships raw, exception-capacity overflow falls back to the
dense fetch, and the NumPy implementations define the semantics the C++
fast paths (native/transport.cpp) must match byte-for-byte.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def _pack_residual_traced(run, x, capacity_frac, jnp):
    """Traced body shared by the D2H-only and duplex transports: run the
    restorer and ship rec − x as 4-bit nibbles + an exact exception list."""
    rec = run(x)
    diff = rec.astype(jnp.int16) - x.astype(jnp.int16)  # [-255, 255]
    b, h, w = x.shape
    k = max(1024, int(b * h * w * capacity_frac))
    d4 = (jnp.clip(diff, -8, 7) + 8).astype(jnp.uint8)
    if w % 2:
        d4 = jnp.pad(d4, ((0, 0), (0, 0), (0, 1)), constant_values=8)
    nib = d4[..., 0::2] | (d4[..., 1::2] << 4)
    exc = (diff > 7) | (diff < -8)
    flat = exc.reshape(-1)
    # sorted indices of exceptions; fill slots point past the end and
    # are ignored by the host (count bounds the real ones)
    (idx,) = jnp.nonzero(flat, size=k, fill_value=b * h * w)
    idx = idx.astype(jnp.int32)
    val = jnp.take(
        diff.reshape(-1), jnp.minimum(idx, b * h * w - 1)
    ).astype(jnp.int16)
    count = flat.sum(dtype=jnp.int32)
    return nib, idx, val, count


def make_packed_restore(run: Callable, capacity_frac: float = 1.0 / 256.0):
    """Wrap fn(uint8 [B,H,W]) -> uint8 [B,H,W] into a packed-transport pair.

    Returns (packed, decode):
      packed(x_dev) -> (nibbles u8 [B,H,ceil(W/2)], idx i32 [K], val i16 [K],
                        count i32)   — all device arrays, D2H ~0.5 B/px
      decode(x_host, fetched) -> rec uint8 [B,H,W]  — bit-exact vs run(x)

    K = max(1024, B*H*W * capacity_frac) exception slots; count > K raises
    OverflowError at decode (exact detection, caller falls back).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def packed(x):
        return _pack_residual_traced(run, x, capacity_frac, jnp)

    return packed, _decode_residual


def _decode_residual(x_host: np.ndarray, fetched) -> np.ndarray:
    """Host side of the packed-residual D2H: rec = x + diff, bit-exact."""
    nib, idx, val, count = (np.asarray(a) for a in fetched)
    b, h, w = x_host.shape
    n = int(count)
    if n > idx.size:
        raise OverflowError(
            f"{n} residual exceptions exceed capacity {idx.size}; "
            "fetch the full recon instead"
        )
    from qcnn_gpu import native

    out = native.residual_decode(x_host, nib, idx, val, n)  # C++ fast path
    if out is not None:
        return out
    d = np.empty((b, h, nib.shape[-1] * 2), np.int16)
    d[..., 0::2] = nib & 15
    d[..., 1::2] = nib >> 4
    d -= 8
    d = np.ascontiguousarray(d[..., :w])
    if n:
        # exception indices address the UNPADDED [B,H,W] raster
        d.reshape(-1)[idx[:n]] = val[:n]
    return (x_host.astype(np.int16) + d).astype(np.uint8)


def measure_stream_fps_packed(
    packed: Callable,
    decode: Callable,
    batches: Sequence[np.ndarray],
    depth: int = 3,
) -> float:
    """measure_stream_fps with packed D2H: the pipelined loop ships the
    nibble residual + exceptions and the host DECODES each batch inside
    the timed window — the restored frames land in host memory, matching
    the reference's timing definition (kernel.cu:89-101) exactly."""
    from qcnn_gpu.engine.stream import pipeline_restore

    state = {"i": 0}

    def sink(fetched):
        decode(batches[state["i"] % len(batches)], fetched)
        state["i"] += 1

    n_frames = sum(b.shape[0] for b in batches)
    t0 = time.perf_counter()
    pipeline_restore(packed, batches, depth=depth, on_output=sink)
    return n_frames / (time.perf_counter() - t0)


def packed_roundtrip_bytes(shape: Tuple[int, int, int], capacity_frac=1.0 / 256.0):
    """(h2d, d2h) bytes per BATCH for the packed transport at [B,H,W]."""
    b, h, w = shape
    k = max(1024, int(b * h * w * capacity_frac))
    return b * h * w, b * h * ((w + 1) // 2) + 6 * k + 4


BLK = 256  # flat-raster block size for the sparse delta transports
RF_RADIUS = 6  # the net's receptive radius (models/topology.RECEPTIVE_RADIUS)


def _start_d2h(*arrays) -> None:
    """Kick off device->host copies without blocking (best effort)."""
    for a in arrays:
        try:
            a.copy_to_host_async()
        except Exception:
            pass  # older jax / non-device arrays: asarray will fetch


def _bucket(n: int, lo: int = 8) -> int:
    if n == 0:
        return 0  # empty class: zero wire bytes, zero-sized operand
    kb = lo
    while kb < n:
        kb *= 2
    return kb


def _pack_payload_numpy(x: np.ndarray, refs: np.ndarray):
    """NumPy block-sparse delta packer — the semantic definition; the
    native C++ packer (native/transport.cpp) must produce byte-identical
    payloads. Three block classes: ALL-ZERO ships nothing (static regions
    of a coded video are bit-identical frame to frame); DENSE-exception
    blocks (moving content) ship raw int8 deltas (260 B beats
    6 B/exception past ~43/256; |d|>127 rides the exception list); the
    rest ship 4-bit nibbles plus a pointwise exception list."""
    d = (x.astype(np.int16) - refs).reshape(-1)
    npx = d.size
    nb_total = -(-npx // BLK)
    if npx % BLK:
        d = np.pad(d, (0, nb_total * BLK - npx))
    blocks = d.reshape(nb_total, BLK)
    exc_cnt = ((blocks > 7) | (blocks < -8)).sum(axis=1)
    nz = (blocks != 0).any(axis=1)
    # raw blocks carry INT8 deltas (a uint8-frame delta exceeds ±127 only
    # at extreme contrast steps; those rare pixels ride the shared
    # pointwise exception list), so raw costs ~260 B vs int16's 516
    raw_sel = nz & (exc_cnt * 6 >= BLK + 4)
    nib_sel = nz & ~raw_sel
    (raw_ids,) = np.nonzero(raw_sel)
    (nib_ids,) = np.nonzero(nib_sel)
    exc_flat = (((blocks > 7) | (blocks < -8)) & nib_sel[:, None]) | (
        ((blocks > 127) | (blocks < -128)) & raw_sel[:, None]
    )
    ne = int(exc_flat.sum())
    kr, kn, ke = _bucket(raw_ids.size), _bucket(nib_ids.size), _bucket(ne)
    raw_idx = np.full(kr, nb_total, np.int32)
    raw_idx[: raw_ids.size] = raw_ids
    raw_val = np.zeros((kr, BLK), np.int8)
    raw_val[: raw_ids.size] = np.clip(blocks[raw_ids], -128, 127)
    d4 = (np.clip(blocks[nib_ids], -8, 7) + 8).astype(np.uint8)
    nib = np.zeros((kn, BLK // 2), np.uint8)
    nib[: nib_ids.size] = d4[:, 0::2] | (d4[:, 1::2] << 4)
    nib_idx = np.full(kn, nb_total, np.int32)
    nib_idx[: nib_ids.size] = nib_ids
    idx = np.full(ke, nb_total * BLK, np.int32)
    val = np.zeros(ke, np.int16)
    if ne:
        ex = np.flatnonzero(exc_flat).astype(np.int32)
        idx[:ne] = ex
        val[:ne] = d[ex]
    return (nib_idx, nib, raw_idx, raw_val, idx, val), int(exc_cnt.sum())


def _predict_changed_blocks(x: np.ndarray, refs: np.ndarray):
    """Flat 256-px block indices whose RESIDUAL delta can be nonzero.

    The restorer is a pure per-frame conv net with receptive radius
    RF_RADIUS (6 px): a residual pixel can
    only change between frames if some input pixel within that radius
    changed. The host knows the input-changed set exactly (it packed the
    deltas), so dilating it by the radius gives a SOUND over-approximation
    of where the residual delta is nonzero — everything outside ships
    nothing and is exactly zero by construction. Dilation runs on 8-px
    tiles (8 >= 6) for speed; returns (block_idx i32 ascending, nb_total).
    """
    b, h, w = x.shape
    ht, wt = -(-h // 8), -(-w // 8)
    chp = np.zeros((b, ht * 8, wt * 8), bool)
    chp[:, :h, :w] = x != refs
    t = chp.reshape(b, ht, 8, wt, 8).any(axis=(2, 4))
    dil = t.copy()
    dil[:, 1:] |= t[:, :-1]
    dil[:, :-1] |= t[:, 1:]
    d2 = dil.copy()
    d2[:, :, 1:] |= dil[:, :, :-1]
    d2[:, :, :-1] |= dil[:, :, 1:]
    px = np.repeat(np.repeat(d2, 8, axis=1), 8, axis=2)[:, :h, :w]
    flat = px.reshape(-1)
    npx = flat.size
    nb = -(-npx // BLK)
    if npx % BLK:
        flat = np.pad(flat, (0, nb * BLK - npx))
    blk = flat.reshape(nb, BLK).any(axis=1)
    return np.nonzero(blk)[0].astype(np.int32), nb


class DuplexTransport:
    """Full-duplex block-sparse packed transport: pack BOTH copies.

    Successive video frames are temporally redundant (the reference feeds
    decoded HEVC sequences frame by frame, kernel.cu:89-101), and the
    restorer is deterministic with a 6-px receptive radius — so BOTH wire
    directions can ship only what changed:

      H2D: each batch goes up as block-sparse temporal deltas vs the
        previous frame (zero / nibble+exceptions / raw-int16 block
        classes, _pack_payload_numpy); the device reconstructs the
        anchors exactly via a telescoping int16 cumsum over the batch
        axis and carries the last frame.
      D2H: the device emits the RESIDUAL-DELTA plane (res[b] − res[b−1],
        4-bit nibbles over the same flat 256-px blocks + an exact
        exception list) but the host fetches ONLY the blocks its own
        input deltas could have touched (_predict_changed_blocks — a
        sound over-approximation by the receptive-radius argument), via
        a bucketed device-side gather. Unfetched blocks are exactly zero.
        The full recon stays device-resident as the lossless fallback
        (exception-capacity overflow => dense fetch, never corruption).

    Every payload is power-of-2 bucketed so only small elementwise
    programs ever retrace; the net + pack program compiles once. All
    state (host previous frame, host residual carry, device anchor and
    residual carries) lives inside the object: `send` from the producer
    thread, `receive` from the consumer thread, in order.

    Bit-exactness contract: receive(x, send(x)) == run(x) for every
    input, for any full/packed interleaving. stats{} tracks measured
    wire bytes and exception fractions for honest accounting.
    """

    def __init__(self, run: Callable, capacity_frac: float = 1.0 / 256.0):
        import jax
        import jax.numpy as jnp

        self._jax, self._jnp = jax, jnp
        self._run = run
        self._cf = capacity_frac
        self.stats = {
            "exc_frac": [], "h2d_bytes": [], "d2h_bytes": [],
            # stage timers (seconds, one entry per batch) for bottleneck
            # hunting on real links: producer pack/predict/upload+dispatch,
            # consumer fetch-wait/decode
            "t_pack": [], "t_predict": [], "t_dispatch": [],
            "t_fetch": [], "t_decode": [],
        }
        self._prev: Optional[np.ndarray] = None  # host u8 [1,H,W]
        self._res: Optional[np.ndarray] = None  # host i16 [1,H,W]
        self._carry = None  # device (anchor u8 [1,H,W], res i16 [1,H,W])
        self._unpack_cache: dict = {}
        self._gather_cache: dict = {}
        self._shape = None
        self._core_shape = None

        @jax.jit
        def step_full(x):
            rec = run(x)
            res = rec.astype(jnp.int16) - x.astype(jnp.int16)
            return (x[-1:], res[-1:]), rec

        self._step_full = step_full
        self._core = None  # built per batch shape

    # ---- device programs ----------------------------------------------

    def _build_core(self, b, h, w):
        """The ONE per-geometry program: net + residual-delta plane. The
        delta pack is deliberately cheap — an earlier format extracted a
        global exception list with jnp.nonzero over the full raster and
        that alone cost ~600 ms/batch on device (vs the net's 76); the
        int8 plane needs only a subtract + pad."""
        jax, jnp = self._jax, self._jnp
        run = self._run
        npx = b * h * w
        nb = -(-npx // BLK)

        @jax.jit
        def core(anchor, prev_res):
            rec = run(anchor)
            res = rec.astype(jnp.int16) - anchor.astype(jnp.int16)
            res_ref = jnp.concatenate([prev_res, res[:-1]], axis=0)
            rd = (res - res_ref).reshape(-1)  # [-510, 510]
            rdp = jnp.pad(rd, (0, nb * BLK - npx)).reshape(nb, BLK)
            return (anchor[-1:], res[-1:]), rdp, rec

        return core

    # H2D buffer layout (single device_put per batch — per-operation
    # round trips through a remote link dominated the loop, measured
    # 671 ms of a 798 ms batch before coalescing): 4-byte segments first
    # so host-side views stay aligned.
    #   [nib_idx i32 kn][raw_idx i32 kr][idx i32 ke][bidx i32 kb]
    #   [val i16 ke][raw_val i16 kr*256][nib u8 kn*128]
    @staticmethod
    def _h2d_layout(kn, kr, ke, kb):
        o = [0]
        for nbytes in (4 * kn, 4 * kr, 4 * ke, 4 * kb, 2 * ke,
                       256 * kr, 128 * kn):
            o.append(o[-1] + nbytes)
        return o

    def _unpack(self, key, b, h, w, kn, kr, ke, kb):
        """Per-bucket jitted unpack: ONE u8 buffer in, anchors out."""
        if key not in self._unpack_cache:
            jax, jnp = self._jax, self._jnp
            from jax import lax

            npx = b * h * w
            nb_total = -(-npx // BLK)
            o = self._h2d_layout(kn, kr, ke, kb)

            def seg(buf, lo, hi, dt, width):
                s = buf[lo:hi]
                if dt == jnp.uint8:
                    return s
                n = (hi - lo) // width
                return lax.bitcast_convert_type(s.reshape(n, width), dt)

            @jax.jit
            def unpack(prev, buf):
                nib_idx = seg(buf, o[0], o[1], jnp.int32, 4)
                raw_idx = seg(buf, o[1], o[2], jnp.int32, 4)
                idx = seg(buf, o[2], o[3], jnp.int32, 4)
                val = seg(buf, o[4], o[5], jnp.int16, 2)
                raw_val = (
                    lax.bitcast_convert_type(buf[o[5]:o[6]], jnp.int8)
                    .astype(jnp.int16)
                    .reshape(kr, BLK)
                )
                nib = seg(buf, o[6], o[7], jnp.uint8, 1).reshape(kn, BLK // 2)
                lo_n = (nib & 15).astype(jnp.int16) - 8
                hi_n = (nib >> 4).astype(jnp.int16) - 8
                dn = jnp.stack([lo_n, hi_n], axis=-1).reshape(kn, BLK)
                d = jnp.zeros((nb_total, BLK), jnp.int16)
                d = d.at[nib_idx].set(dn, mode="drop")
                d = d.at[raw_idx].set(raw_val, mode="drop")
                d = d.reshape(-1).at[idx].set(val, mode="drop")
                d = d[:npx].reshape(b, h, w)
                cums = jnp.cumsum(d, axis=0, dtype=jnp.int16)
                return (prev.astype(jnp.int16) + cums).astype(jnp.uint8)

            self._unpack_cache[key] = unpack
        return self._unpack_cache[key]

    def _fetchpack(self, key, kn, kr, ke, kb):
        """Per-bucket jitted gather + output coalescing: the predicted
        residual-delta blocks leave the device as ONE u8 buffer
        (one async fetch per batch):
          [rows int8 kb*256][overflow u8 x4]
        rows are int8-clipped deltas; `overflow` is set when ANY gathered
        delta exceeds int8 (rd = res[b]−res[b−1] ∈ [-510, 510]; beyond
        ±127 needs a >127-level residual jump — the host then falls back
        to the dense recon fetch, lossless). No per-pixel exception list:
        extracting one on device (global nonzero) measured ~600 ms/batch.
        """
        if key not in self._gather_cache:
            jax, jnp = self._jax, self._jnp
            from jax import lax

            o = self._h2d_layout(kn, kr, ke, kb)

            @jax.jit
            def fetchpack(rdp, buf):
                bidx = lax.bitcast_convert_type(
                    buf[o[3]:o[4]].reshape(kb, 4), jnp.int32
                )
                rows = jnp.take(rdp, bidx, axis=0, mode="fill", fill_value=0)
                over = ((rows > 127) | (rows < -128)).any()
                rows8 = jnp.clip(rows, -128, 127).astype(jnp.int8)
                tail = jnp.full((4,), over.astype(jnp.uint8), jnp.uint8)
                return jnp.concatenate([
                    lax.bitcast_convert_type(rows8, jnp.uint8).reshape(-1),
                    tail,
                ])

            self._gather_cache[key] = fetchpack
        return self._gather_cache[key]

    # ---- producer side -------------------------------------------------

    def send(self, x: np.ndarray, _force_numpy: bool = False):
        """Pack + dispatch one batch (non-blocking); returns the work item
        for `receive`. Must be called in stream order."""
        jax = self._jax
        prev = self._prev
        # snapshot (not view): callers that reuse their frame buffer
        # between batches must not mutate the host reference frame out
        # from under the device anchor carry
        self._prev = np.array(x[-1:], copy=True)
        self._shape = x.shape
        payload = None
        if prev is not None:
            refs = np.concatenate([prev, x[:-1]], axis=0)
            t0 = time.perf_counter()
            res = None
            if not _force_numpy:
                from qcnn_gpu import native

                res = native.duplex_pack(x, refs, _bucket)  # C++ fast path
            if res is None:
                res = _pack_payload_numpy(x, refs)
            self.stats["t_pack"].append(time.perf_counter() - t0)
            payload, n_exc_all = res
            self.stats["exc_frac"].append(n_exc_all / x.size)
            wire = sum(a.nbytes for a in payload)
            if wire >= x.nbytes:  # content too hot for the format
                payload = None
            else:
                t0 = time.perf_counter()
                pred = None
                if not _force_numpy:
                    pred = native.duplex_predict(x, refs)  # C++ fast path
                bidx, nbp = (
                    pred if pred is not None else _predict_changed_blocks(x, refs)
                )
                kb = _bucket(bidx.size)
                bidx_p = np.full(kb, nbp, np.int32)
                bidx_p[: bidx.size] = bidx
                self.stats["t_predict"].append(time.perf_counter() - t0)
        if payload is None or self._carry is None:
            self.stats["h2d_bytes"].append(x.nbytes)
            self._carry, rec = self._step_full(jax.device_put(x))
            _start_d2h(rec)
            return ("full", rec, x.shape)
        self.stats["h2d_bytes"].append(wire + bidx_p.nbytes)
        t0 = time.perf_counter()
        b, h, w = x.shape
        if self._core is None or self._core_shape != (b, h, w):
            self._core = self._build_core(b, h, w)
            self._core_shape = (b, h, w)
        nib_idx, nib, raw_idx, raw_val, idx_h, val_h = payload
        kn, kr, ke = nib_idx.size, raw_idx.size, idx_h.size
        # ONE H2D buffer (layout in _h2d_layout) and ONE D2H buffer per
        # batch: each separate device_put/fetch costs a round trip on a
        # remote link, and those dominated the loop (measured 671 ms of
        # a 798 ms batch). rec stays device-resident (fallback only).
        buf = np.concatenate([
            nib_idx.view(np.uint8), raw_idx.view(np.uint8),
            idx_h.view(np.uint8), bidx_p.view(np.uint8),
            val_h.view(np.uint8).ravel(), raw_val.view(np.uint8).ravel(),
            nib.view(np.uint8).ravel(),
        ])
        key = (b, h, w, kn, kr, ke, kb)
        buf_dev = jax.device_put(buf)
        anchor = self._unpack(key, b, h, w, kn, kr, ke, kb)(
            self._carry[0], buf_dev
        )
        self._carry, rdp, rec = self._core(anchor, self._carry[1])
        gout = self._fetchpack(key, kn, kr, ke, kb)(rdp, buf_dev)
        _start_d2h(gout)
        self.stats["t_dispatch"].append(time.perf_counter() - t0)
        return ("packed", gout, rec, bidx_p, nbp, kb, x.shape)

    # ---- consumer side -------------------------------------------------

    def _receive_full(self, x, rec_dev):
        rec = np.asarray(rec_dev)
        self.stats["d2h_bytes"].append(rec.nbytes)
        self._res = (rec[-1:].astype(np.int16) - x[-1:].astype(np.int16))
        return rec

    def receive(self, x: np.ndarray, item) -> np.ndarray:
        """Fetch + decode one batch (blocking); same order as `send`."""
        if item[0] == "full":
            return self._receive_full(x, item[1])
        _, gout, rec_dev, bidx_p, nbp, kb, shape = item
        b, h, w = shape
        npx = b * h * w
        t0 = time.perf_counter()
        buf = np.asarray(gout)  # ONE fetch: int8 rows || overflow flag
        self.stats["t_fetch"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if buf[-4]:  # a gathered delta exceeded int8: dense fallback
            return self._receive_full(x, rec_dev)
        rows = buf[: kb * BLK].view(np.int8).reshape(kb, BLK)
        self.stats["d2h_bytes"].append(buf.nbytes)
        from qcnn_gpu import native

        out = native.duplex_decode8(x, rows, bidx_p, nbp, self._res)
        if out is not None:  # C++ fast path; NumPy below is the semantics
            rec, self._res = out
            self.stats["t_decode"].append(time.perf_counter() - t0)
            return rec
        rdp = np.zeros((nbp, BLK), np.int16)
        valid = bidx_p < nbp
        rdp[bidx_p[valid]] = rows[valid]
        rd = rdp.reshape(-1)[:npx].reshape(b, h, w)
        res = self._res + np.cumsum(rd, axis=0, dtype=np.int16)
        rec = (x.astype(np.int16) + res).astype(np.uint8)
        self._res = res[-1:]
        self.stats["t_decode"].append(time.perf_counter() - t0)
        return rec


def make_duplex_restore(run: Callable, capacity_frac: float = 1.0 / 256.0):
    """Construct the duplex transport (see DuplexTransport)."""
    return DuplexTransport(run, capacity_frac)


def pipeline_restore_duplex(
    transport: DuplexTransport,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    on_output: Optional[Callable] = None,
):
    """pipeline_restore with the duplex transport: the producer packs +
    dispatches (transport.send), the fetcher thread fetches + decodes
    (transport.receive) — both directions overlapped, both block-sparse.
    All carries live in the transport, so a stream continued across calls
    never pays the cold-start full-frame copies."""
    import queue
    import threading

    outs: list = []
    sink = on_output if on_output is not None else outs.append
    err: list = []
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    done = object()

    def fetcher():
        failed = False
        while True:
            item = q.get()
            if item is done:
                return
            if failed:
                continue
            try:
                sink(transport.receive(*item))
            except BaseException as e:
                err.append(e)
                failed = True

    th = threading.Thread(target=fetcher, daemon=True)
    th.start()
    try:
        for x in batches:
            if err:
                break
            q.put((x, transport.send(x)))
    finally:
        q.put(done)
        th.join()
    if err:
        raise err[0]
    return outs


def measure_stream_fps_duplex(
    transport: DuplexTransport,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    on_output: Optional[Callable] = None,
) -> float:
    """Wall-clock fps of the duplex loop: host pack, sparse H2D, device
    unpack+restore+delta-pack, predicted-sparse D2H, host decode — ALL
    inside the timed window (the reference's timing definition with both
    copies packed, kernel.cu:89-101)."""
    n_frames = sum(b.shape[0] for b in batches)
    t0 = time.perf_counter()
    pipeline_restore_duplex(
        transport, batches, depth=depth,
        on_output=on_output if on_output is not None else (lambda a: None),
    )
    return n_frames / (time.perf_counter() - t0)


def duplex_roundtrip_bytes(shape: Tuple[int, int, int], capacity_frac=1.0 / 256.0):
    """(h2d, d2h) bytes per BATCH for the duplex transport as UPPER
    bounds (every block active, full exception capacity) — real streams
    with static regions land far lower; see transport.stats for measured."""
    b, h, w = shape
    k = max(1024, int(b * h * w * capacity_frac))
    nb = -(-b * h * w // 256)
    return nb * (4 + 128), nb * 128 + 6 * k + 4
