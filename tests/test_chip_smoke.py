"""chip_smoke.py on the CPU: its helpers, its refusal to run off a GPU, and
every phase rehearsed at tiny sizes (the four-card phases on 4 of the 8
virtual CPU devices)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from qcnn_gpu.engine.validate import oracle_windows, windows_mismatch, window_origins  # noqa: E402
from qcnn_gpu.models import oracle as O  # noqa: E402
from qcnn_gpu.testing import synth_engine_params, synth_frames  # noqa: E402


def test_refuses_cpu_platform():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert "GPU" in str(e.value)


def test_script_exits_nonzero_without_gpu():
    """The script itself, as a user runs it: non-zero exit, no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize(
    "line,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
        ("NVIDIA H100 80GB HBM3, 500.00 W\n", ("NVIDIA H100 80GB HBM3", "500.00 W")),
        ("Some, Card, Name, [N/A]", ("Some, Card, Name", "[N/A]")),
    ],
)
def test_parse_card_line(line, want):
    assert chip_smoke.parse_card_line(line) == want


def test_parse_card_line_rejects_garbage():
    with pytest.raises(ValueError):
        chip_smoke.parse_card_line("no comma here")


def test_result_line_keys():
    devs = jax.devices()[:1]
    last = json.loads(chip_smoke.result_line(devs))
    assert list(last) == ["ok", "device"] and last["ok"] is True
    assert list(last["device"]) == ["platform", "kind", "count"]
    assert last["device"] == {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": 1,
    }


@pytest.mark.parametrize("h,w,size", [(70, 90, 20), (32, 32, 20), (45, 200, 16)])
def test_oracle_windows_equal_full_frame(h, w, size):
    p = synth_engine_params(27)
    x = synth_frames(2, h, w, seed=h + w)
    full = O.forward_blu(x, p)
    wins = oracle_windows(x, p, size=size)
    assert [o for o, _ in wins] == window_origins(h, w, size)
    for (y, xo), want in wins:
        assert (want == full[:, y : y + size, xo : xo + size]).all()
    assert windows_mismatch(full, wins) == 0
    bad = full.copy()
    bad[1, h - 1, w - 1] ^= 1  # the bottom-right corner is in a window
    assert windows_mismatch(bad, wins) == 1


def test_phase_cli_tiny(tmp_path):
    chip_smoke.phase_cli(str(tmp_path), 24, 40, 3)


def test_phase_engine_tiny(tmp_path):
    chip_smoke.phase_engine(str(tmp_path), jax.devices()[0], hd=(24, 40),
                            uhd=(32, 48), small=(16, 24), n_hd=3, n_uhd=1, n_small=2)


def test_time_forms_tiny():
    times = chip_smoke.time_forms(h=16, w=24, batch=2, iters=1, reps=2)
    assert set(times) == set(chip_smoke.FORMS)
    assert all(first > 0 and len(ts) == 2 and min(ts) > 0 for first, ts in times.values())


@pytest.mark.parametrize("name", sorted(chip_smoke.FORMS))
def test_form_program_exact(name):
    p = synth_engine_params(37)
    x = synth_frames(2, 20, 28, seed=11)
    x[1] = 255
    run = chip_smoke.form_program(p, *chip_smoke.FORMS[name])
    assert (np.asarray(run(x)) == O.forward_blu(x, p)).all()


def test_compare_forms_tiny():
    chip_smoke.compare_forms(geos=((24, 40, 2), (16, 24, 1)))


def test_phase_forms_tiny():
    chip_smoke.phase_forms(jax.devices()[0], geos=((16, 24, 1),), h=16, w=24, batch=2,
                           iters=1, reps=1)


def test_phase_train_tiny():
    chip_smoke.phase_train(batch=2, patch=16)


def test_mesh_engine_on_4_cpu_devices(tmp_path):
    chip_smoke.phase_mesh_engine(str(tmp_path), jax.devices()[:4], h=24, w=40)


def test_mesh_2d_on_4_cpu_devices():
    chip_smoke.phase_mesh_2d(jax.devices()[:4], h=48, w=64)


def test_mesh_train_on_4_cpu_devices():
    chip_smoke.phase_mesh_train(jax.devices()[:4], batch=8, patch=16)
