"""REAL multi-process jax.distributed test (2 processes x 4 CPU devices).

The reference has nothing to compare here (single-GPU); SURVEY §4 calls
for multi-host testing via jax.distributed with CPU devices. This spawns
two actual processes that join one process group over a local TCP
coordinator, shard a global frame batch (each feeds its local half),
restore under the global mesh program, all-gather, and check bit-exactness
against the oracle in BOTH processes.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update('jax_platforms', 'cpu')
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{{port}}", num_processes=nproc, process_id=pid
    )
    import numpy as np
    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.parallel.distributed import DistributedRunner
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    ndev = len(jax.devices())
    assert jax.process_count() == nproc
    mesh = make_mesh(ndev, 1)
    p = synth_engine_params(37)
    runner = DistributedRunner(p, mesh=mesh, impl="int")
    gframes = synth_frames(ndev * 2, 32, 48, seed=5)
    local = np.array_split(gframes, nproc)[pid]
    out = runner.restore(local)
    want = O.forward_blu(gframes, p)
    assert out.shape == want.shape and (out == want).all()
    print(f"MHOK {{pid}}")
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_restore(tmp_path):
    # hang guard: communicate(timeout=240) below (pytest-timeout not installed)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    env["JAX_PLATFORM_NAME"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=240)
        outs.append(out)
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"MHOK {i}" in out


def test_distributed_runner_duplex_stream_bit_exact():
    """The duplex block-sparse wire COMPOSED with the sharded mesh program
    (VERDICT r3 #4): temporal-delta H2D -> sharded restore (halo
    ppermutes) -> predicted-sparse D2H, chained over multiple batches,
    bit-exact vs the oracle."""
    import numpy as np

    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.parallel.distributed import DistributedRunner
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    p = synth_engine_params(37)
    mesh = make_mesh(2, 4)
    r = DistributedRunner(p, mesh=mesh, impl="int")
    # video-like stream: slowly-varying frames so the delta wire is
    # exercised in its sparse regime, plus a ragged tail
    base = synth_frames(1, 4 * 16, 48, seed=50)[0]
    rng = np.random.default_rng(0)
    frames = np.stack([
        np.clip(base.astype(int) + rng.integers(-2, 3, base.shape), 0, 255)
        for _ in range(7)
    ]).astype(np.uint8)
    want = O.forward_blu(frames, p)
    got = r.restore_stream(frames, transport="duplex", batch_frames=2)
    assert got.shape == want.shape
    assert (got == want).all(), f"{np.sum(got != want)} mismatches (duplex x mesh)"
    # raw transport through the same mesh program agrees
    got_raw = r.restore_stream(frames, transport="raw", batch_frames=2)
    assert (got_raw == want).all()
    # a different batch size builds a FRESH duplex wire instead of
    # desyncing the cached one (per-(geometry, bs) cache, ADVICE r4)
    got_b4 = r.restore_stream(frames, transport="duplex", batch_frames=4)
    assert (got_b4 == want).all()
    assert len(r._duplex) == 2, "expected one transport per (geometry, bs) key"


def test_distributed_runner_duplex_on_2d_mesh():
    """Duplex wire into a 2-D (dp, sp, sw) sharded restore."""
    import numpy as np

    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.parallel.distributed import DistributedRunner
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    p = synth_engine_params(27)
    mesh = make_mesh(2, 2, sw=2)
    r = DistributedRunner(p, mesh=mesh, impl="int")
    frames = synth_frames(4, 2 * 16, 2 * 24, seed=51)
    want = O.forward_blu(frames, p)
    got = r.restore_stream(frames, transport="duplex", batch_frames=2)
    assert (got == want).all(), f"{np.sum(got != want)} mismatches (duplex x 2-D mesh)"


def test_distributed_runner_duplex_failure_raises(monkeypatch):
    """A mid-stream duplex failure on the mesh raises (no quiet switch to
    the raw transport) and evicts only that (geometry, batch) transport;
    the next duplex stream builds a fresh one and is bit-exact."""
    import numpy as np

    from qcnn_gpu.engine.packed import DuplexTransport
    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.parallel.distributed import DistributedRunner
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    p = synth_engine_params(37)
    r = DistributedRunner(p, mesh=make_mesh(2, 2), impl="int")
    frames = synth_frames(6, 2 * 16, 48, seed=52)
    want = O.forward_blu(frames, p)
    r.restore_stream(frames[:4], transport="duplex", batch_frames=4)
    calls = {"n": 0}
    orig = DuplexTransport.receive

    def flaky(self, x, item):
        calls["n"] += 1
        if calls["n"] == 2:  # fail mid-stream, after the carries advanced
            raise RuntimeError("injected link failure")
        return orig(self, x, item)

    monkeypatch.setattr(DuplexTransport, "receive", flaky)
    with pytest.raises(RuntimeError, match="injected link failure"):
        r.restore_stream(frames, transport="duplex", batch_frames=2)
    assert ((2 * 16, 48), 2) not in r._duplex  # the desynced transport went
    assert ((2 * 16, 48), 4) in r._duplex  # other keys stay
    monkeypatch.setattr(DuplexTransport, "receive", orig)
    got = r.restore_stream(frames, transport="duplex", batch_frames=2)
    assert (got == want).all()


THROUGHPUT_WORKER = textwrap.dedent(
    """
    import sys, time
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update('jax_platforms', 'cpu')
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{{port}}", num_processes=nproc,
            process_id=pid,
        )
    import numpy as np
    from qcnn_gpu.parallel.distributed import DistributedRunner
    from qcnn_gpu.parallel.mesh import make_mesh
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    ndev = len(jax.devices())
    mesh = make_mesh(ndev, 1)
    p = synth_engine_params(37)
    runner = DistributedRunner(p, mesh=mesh, impl="int")
    gframes = synth_frames(ndev * nproc * 2, 32, 48, seed=5)
    local = np.array_split(gframes, nproc)[pid] if nproc > 1 else gframes
    bs = local.shape[0] // 2
    batches = [local[:bs], local[bs:]]
    for b in batches:  # warmup/compile outside the timed loop
        runner.restore(b)
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        runner.restore(batches[i % 2])
    dt = time.perf_counter() - t0
    # every process restores the same GLOBAL stream (allgather), so global
    # throughput is global frames / wall time
    fps = n * gframes.shape[0] / dt
    print(f"THROUGHPUT {{pid}} {{fps:.3f}}")
    """
)


def _run_throughput(nproc: int, total_devices: int, tmp_path) -> float:
    script = tmp_path / f"tw{nproc}.py"
    script.write_text(THROUGHPUT_WORKER.format(repo=REPO))
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={total_devices // nproc}"
    )
    env.pop("JAX_PLATFORMS", None)
    env["JAX_PLATFORM_NAME"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(nproc), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nproc)
    ]
    fps = []
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=300)
        outs.append(out)
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {i}/{nproc} failed:\n{out[-2000:]}"
        for line in out.splitlines():
            if line.startswith(f"THROUGHPUT {i} "):
                fps.append(float(line.split()[2]))
    assert len(fps) == nproc, outs
    return min(fps)


def test_two_process_throughput_overhead(tmp_path):
    """MEASURED multi-process overhead (VERDICT r4 #6): the same global
    stream restored by 2 processes x 2 devices vs 1 process x 4 devices
    (same total device count, same global batch). The 2-process run adds
    jax.distributed dispatch + a cross-process allgather of restored
    tiles per batch over local TCP; the gate bounds that composition
    overhead rather than asserting scaling (CPU devices share the same
    two physical cores, so speedup is not expected — the number that
    matters on a real cluster is the OVERHEAD factor)."""
    fps1 = _run_throughput(1, 4, tmp_path)
    fps2 = _run_throughput(2, 4, tmp_path)
    assert fps2 > 0 and fps1 > 0
    overhead = fps1 / fps2
    print(f"multihost throughput: 1proc {fps1:.2f} fps, 2proc {fps2:.2f} fps, "
          f"overhead x{overhead:.2f}")
    # generous bound: the distributed composition must not collapse (a
    # deadlocked allgather or per-batch recompile shows up as 10-100x)
    assert overhead < 4.0, f"2-process overhead x{overhead:.2f}"
