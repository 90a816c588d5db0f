"""Pipelined host<->device frame streaming.

The reference times its frame loop INCLUDING the per-frame H2D/D2H copies
(kernel.cu:89-101) but runs them fully serialized: memcpy -> forward ->
memcpy, one frame at a time. A GPU's copy engines move data while its
SMs compute, so this loop keeps a pipeline of in-flight
batches: while batch i's restored frames are being fetched, batch i+1 is
computing and batch i+2's input is in transfer (the double-buffered
producer idea of the reference's training loader, train_data.py:132-177,
applied to inference).

`device_put` and compiled-program dispatch are asynchronous in JAX; the
only blocking call is the final fetch of each output. Bounding the number
of in-flight batches (`depth`) bounds device memory while keeping the
transfer<->compute overlap.

A fetcher thread pulls outputs to host off the main thread: np.asarray on
a jax Array releases the GIL while the D2H transfer runs, so the main
thread keeps enqueueing H2D + compute work concurrently — without this,
a slow host link serializes fetch-then-send even though the device could
overlap both directions.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np


def pipeline_restore(
    run: Callable,
    batches: Iterable[np.ndarray],
    depth: int = 3,
    device=None,
    on_output: Optional[Callable[[np.ndarray], None]] = None,
) -> List[np.ndarray]:
    """Stream uint8 frame batches through `run` with `depth` batches in
    flight. Returns the restored batches (or feeds them to `on_output`
    in order and returns [] if given)."""
    import jax

    outs: List[np.ndarray] = []
    sink = on_output if on_output is not None else outs.append
    err: List[BaseException] = []
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    done = object()

    def fetcher():
        failed = False
        while True:
            item = q.get()
            if item is done:
                return
            if failed:
                continue  # keep draining so the producer's q.put never
                # deadlocks against a full queue after an error
            try:
                # tuple outputs (e.g. the packed-residual transport,
                # engine/packed.py) fetch component-wise
                if isinstance(item, (tuple, list)):
                    sink(tuple(np.asarray(a) for a in item))
                else:
                    sink(np.asarray(item))
            except BaseException as e:  # surfaced on the main thread
                err.append(e)
                failed = True

    th = threading.Thread(target=fetcher, daemon=True)
    th.start()
    try:
        for x in batches:
            if err:
                break
            # UNCOMMITTED placement (no explicit device): committed arrays
            # change the jit dispatch key vs the numpy-input warmup path and
            # force a recompile INSIDE the streaming loop. An explicit
            # `device` opts into committed placement (multi-device callers).
            staged = jax.device_put(x, device) if device is not None else jax.device_put(x)
            out = run(staged)  # async dispatch
            # start D2H copies immediately: component fetches on the
            # fetcher thread would otherwise serialize one link round
            # trip EACH (multi-array outputs like the packed transport)
            for a in out if isinstance(out, (tuple, list)) else (out,):
                try:
                    a.copy_to_host_async()
                except Exception:
                    pass
            q.put(out)  # blocks only when the pipeline is `depth`
            # deep (backpressure)
    finally:
        q.put(done)
        th.join()
    if err:
        raise err[0]
    return outs


def measure_stream_fps(
    run: Callable,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    device=None,
) -> float:
    """Wall-clock frames/s of the full pipelined loop: first H2D enqueue
    to last restored frame landed in host memory — the reference's timing
    definition (kernel.cu:89-101), overlapped."""
    n_frames = sum(b.shape[0] for b in batches)
    t0 = time.perf_counter()
    pipeline_restore(run, batches, depth=depth, device=device, on_output=lambda a: None)
    return n_frames / (time.perf_counter() - t0)
