"""Model-file formats: round trips and layout-converter inverses."""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.data import model_files as MF
from qcnn_gpu.testing import synth_dynamic_params, synth_engine_params, synth_float_weights


def _assert_engine_equal(a, b):
    for i in range(6):
        assert (a.weights[i] == b.weights[i]).all()
        assert (a.biases[i] == b.biases[i]).all()
    assert a.blu_q == b.blu_q and a.mul == b.mul and a.shift == b.shift


def test_static_qfp_hwcn_roundtrip(tmp_path):
    p = synth_engine_params(37)
    path = str(tmp_path / "m.hwcn")
    MF.write_static_qfp_hwcn(path, p)
    _assert_engine_equal(MF.read_static_qfp_hwcn(path), p)


def test_static_qfp_vect_c_roundtrip(tmp_path):
    p = synth_engine_params(32)
    path = str(tmp_path / "m.vectc")
    MF.write_static_qfp_vect_c(path, p)
    _assert_engine_equal(MF.read_static_qfp_vect_c(path), p)


def test_vect_c_file_size_matches_engine_contract(tmp_path):
    """wSize per layer is k*k*ceil4(cin)*cout bytes (cnn.cu:24) + 4*cout
    bias + 12 bytes of blu/mul/shift."""
    p = synth_engine_params(27)
    path = str(tmp_path / "m.vectc")
    MF.write_static_qfp_vect_c(path, p)
    import os

    expected = 0
    for (k, cin, cout) in ((5, 1, 64), (3, 64, 32), (5, 64, 16), (3, 48, 16), (1, 48, 32), (3, 48, 1)):
        cin4 = (cin + 3) // 4 * 4
        expected += k * k * cin4 * cout + 4 * cout + 12
    assert os.path.getsize(path) == expected


def test_dynamic_roundtrip(tmp_path):
    p = synth_dynamic_params(22)
    path = str(tmp_path / "m.dyn")
    MF.write_dynamic_hwcn(path, p)
    q = MF.read_dynamic_hwcn(path)
    assert q.step_w == p.step_w
    for i in range(6):
        assert (q.weights[i] == p.weights[i]).all()
        assert (q.biases[i] == p.biases[i]).all()


def test_dynamic_vect_c_roundtrip_and_size(tmp_path):
    """Engine-side dynamic file (qvrcnn.cu:398-414): per layer
    [stepw i32][w int8 NCHW_VECT_C][b i32*cout] — roundtrip plus the
    INT8x4 engine's wSize contract (k*k*ceil4(cin)*cout, cnn.cu:24)."""
    import os

    p = synth_dynamic_params(27)
    path = str(tmp_path / "m.dynvc")
    MF.write_dynamic_vect_c(path, p)
    q = MF.read_dynamic_vect_c(path)
    assert q.step_w == p.step_w
    for i in range(6):
        assert (q.weights[i] == p.weights[i]).all()
        assert (q.biases[i] == p.biases[i]).all()
    expected = 0
    for (k, cin, cout) in ((5, 1, 64), (3, 64, 32), (5, 64, 16), (3, 48, 16), (1, 48, 32), (3, 48, 1)):
        cin4 = (cin + 3) // 4 * 4
        expected += 4 + k * k * cin4 * cout + 4 * cout
    assert os.path.getsize(path) == expected


def test_float_nchw_roundtrip_and_size(tmp_path):
    """Plain float NCHW engine file (cnn.cu:113-128): per layer
    [w f32 NCHW][b f32*cout], no channel padding under FLOAT_CONFIG."""
    import os

    ws, bs = synth_float_weights(5)
    path = str(tmp_path / "m.fnchw")
    MF.write_float_nchw(path, ws, bs)
    ws2, bs2 = MF.read_float_nchw(path)
    for a, b in zip(ws, ws2):
        assert (a == b).all()
    for a, b in zip(bs, bs2):
        assert (a == b).all()
    expected = 0
    for (k, cin, cout) in ((5, 1, 64), (3, 64, 32), (5, 64, 16), (3, 48, 16), (1, 48, 32), (3, 48, 1)):
        expected += 4 * (k * k * cin * cout + cout)
    assert os.path.getsize(path) == expected


def test_cli_convert_all_families(tmp_path):
    """cli convert handles all five on-disk formats, within-family."""
    from qcnn_gpu.cli import main as cli_main

    p = synth_engine_params(37)
    src = str(tmp_path / "m.hwcn")
    dst = str(tmp_path / "m.vectc")
    MF.write_static_qfp_hwcn(src, p)
    assert cli_main(["convert", "--infile", src, "--informat", "hwcn",
                     "--outfile", dst, "--outformat", "vect_c"]) == 0
    _assert_engine_equal(MF.read_static_qfp_vect_c(dst), p)

    d = synth_dynamic_params(22)
    src = str(tmp_path / "m.dyn")
    dst = str(tmp_path / "m.dynvc")
    MF.write_dynamic_hwcn(src, d)
    assert cli_main(["convert", "--infile", src, "--informat", "dyn_hwcn",
                     "--outfile", dst, "--outformat", "dyn_vect_c"]) == 0
    d2 = MF.read_dynamic_vect_c(dst)
    assert d2.step_w == d.step_w
    for i in range(6):
        assert (d2.weights[i] == d.weights[i]).all()

    ws, bs = synth_float_weights(7)
    src = str(tmp_path / "m.fhwcn")
    dst = str(tmp_path / "m.fnchw")
    MF.write_float_hwcn(src, ws, bs)
    assert cli_main(["convert", "--infile", src, "--informat", "float_hwcn",
                     "--outfile", dst, "--outformat", "float_nchw"]) == 0
    ws2, _ = MF.read_float_nchw(dst)
    for a, b in zip(ws, ws2):
        assert (a == b).all()

    # cross-family conversion is rejected with a clean error code
    assert cli_main(["convert", "--infile", src, "--informat", "float_hwcn",
                     "--outfile", dst, "--outformat", "vect_c"]) == 2


def test_float_roundtrip(tmp_path):
    ws, bs = synth_float_weights(3)
    path = str(tmp_path / "m.float")
    MF.write_float_hwcn(path, ws, bs)
    ws2, bs2 = MF.read_float_hwcn(path)
    for a, b in zip(ws, ws2):
        assert (a == b).all()
    for a, b in zip(bs, bs2):
        assert (a == b).all()


def test_layout_converters_inverse():
    rng = np.random.default_rng(0)
    for (h, w, c, n) in ((5, 5, 1, 64), (3, 3, 48, 16), (1, 1, 48, 32)):
        x = rng.integers(-128, 128, size=(h, w, c, n)).astype(np.int8)
        v = MF.hwcn_to_nchw_vect_c(x)
        assert v.shape == (n, (c + 3) // 4, h, w, 4)
        back = MF.nchw_vect_c_to_hwcn(v, c)
        assert (back == x).all()
        assert (MF.nchw_to_hwcn(MF.hwcn_to_nchw(x)) == x).all()


def test_vect_c_padding_zeros():
    """Cin=1 pads to 4 lanes; lanes 1..3 must be zero (mat.cu:106-108)."""
    x = np.ones((5, 5, 1, 8), dtype=np.int8)
    v = MF.hwcn_to_nchw_vect_c(x)
    assert (v[..., 0] == 1).all()
    assert (v[..., 1:] == 0).all()


def test_psnr_goldens_readable():
    from qcnn_gpu.testing import asset

    for qp in (22, 27, 32, 37):
        g = MF.read_psnr_goldens(asset(f"psnr_static_{qp}.data"))
        assert g.shape == (18,)
        assert (g > 25).all() and (g < 50).all()


def test_append_psnr_record(tmp_path):
    path = str(tmp_path / "recon_psnr.data")
    MF.append_psnr_record(path, 41.5)
    MF.append_psnr_record(path, 42.5)
    assert (MF.read_psnr_goldens(path) == [41.5, 42.5]).all()
