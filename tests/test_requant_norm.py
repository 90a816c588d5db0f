"""mul/shift normalization — exact-identity + int32-envelope guard.

An INT4 solve produced (mul=2^25, shift=27) for a near-degenerate layer;
the int32 engine requant silently wrapped (oracle 43.4405 dB vs engine
43.4055 on the committed INT4 QP22 model) until the engine began
stripping common powers of two at model build (an exact identity for
both reference rounding forms) and range-checking what remains.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.quick  # fast host tier: `pytest -m quick`

from qcnn_gpu.ops.requant import (
    check_blu_requant_i32_safe,
    normalize_mul_shift,
)


def _pre(u, blu_q, mul, shift):
    u = int(u)
    if u > blu_q:
        return 127
    if u < 0:
        return 0
    return ((u + (1 << (shift - 1)) // mul) * mul) >> shift


def _post(u, mul, shift):
    return (int(u) * mul + (1 << (shift - 1))) >> shift


def test_normalize_strips_powers_of_two():
    assert normalize_mul_shift(1 << 25, 27) == (1, 2)
    assert normalize_mul_shift(3 << 23, 27) == (3, 4)
    assert normalize_mul_shift(723, 16) == (723, 16)  # odd: untouched
    # shift floor of 1 (bias formula needs shift-1 >= 0)
    assert normalize_mul_shift(4, 2) == (2, 1)


@pytest.mark.parametrize("mul,shift", [(1 << 25, 27), (6 << 20, 24), (723, 16), (10, 5)])
def test_normalization_is_exact_identity(mul, shift):
    m2, s2 = normalize_mul_shift(mul, shift)
    rng = np.random.default_rng(0)
    blu_q = 510
    for u in np.concatenate([
        rng.integers(-(1 << 20), 1 << 20, 200),
        np.array([0, -1, 1, blu_q, blu_q + 1, blu_q - 1]),
    ]):
        assert _pre(u, blu_q, mul, shift) == _pre(u, blu_q, m2, s2), (u, mul, shift)
        assert _post(u, mul, shift) == _post(u, m2, s2), (u, mul, shift)


def test_engine_guard_raises_on_unrepresentable_table():
    # an ODD huge mul cannot be normalized away -> must raise, not wrap
    with pytest.raises(ValueError, match="int32 engine envelope"):
        check_blu_requant_i32_safe(blu_q=100000, mul=(1 << 25) + 1, shift=27)
    check_blu_requant_i32_safe(blu_q=11512, mul=723, shift=16)  # shipped table: fine


def test_int4_model_engine_matches_oracle_end_to_end():
    """The original failure, as a fixture-free regression: synthesize a
    table with a power-of-two-heavy (mul, shift) on one layer and assert
    engine == oracle bit-for-bit."""
    from qcnn_gpu.models import oracle as O
    from qcnn_gpu.models.qvrcnn import make_forward
    from qcnn_gpu.testing import synth_engine_params, synth_frames

    p = synth_engine_params(37)
    mul = list(p.mul)
    shift = list(p.shift)
    blu_q = list(p.blu_q)
    # the INT4-solve shape that wrapped; blu_q must satisfy the BLU-window
    # invariant for the new scale ((blu_q+bias)*mul >> shift <= 127, as
    # every real solver table does): (508+2)*2^25 >> 27 == 127
    mul[4], shift[4], blu_q[4] = 1 << 25, 27, 508
    import dataclasses

    p2 = dataclasses.replace(
        p, mul=tuple(mul), shift=tuple(shift), blu_q=tuple(blu_q)
    )
    x = synth_frames(2, 32, 48, seed=9)
    want = O.forward_blu(x, p2)
    got = np.asarray(make_forward(p2, impl="int")(x))
    assert (got == want).all()
