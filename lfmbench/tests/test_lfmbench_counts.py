"""The work counts and bounds against hand-worked values."""

import pytest

from lfmbench import counts


def test_train_step_flops_at_dense10k():
    # potrf n^3/3 + L^-1 n^3/3 + Sigma^-1 n^3/3 + two solves 2 n^2, n = 1e4
    assert counts.train_step_flops(10_000) == 1e12 + 2e8


def test_predict_flops_at_dense10k():
    # n^3/3 + 2 n^2 m + 2 m^2 n + 2 n m with n = 1e4, m = 5000
    want = 1e12 / 3 + 1e12 + 5e11 + 1e8
    assert counts.predict_flops(10_000, 5000) == pytest.approx(want, rel=1e-15)


def test_peaks():
    assert counts.PEAK_FLOPS == {"float32": 165e12, "float64": 67e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("rows, cols, ms", [
    (10_000, 10_000, 0.11940298507462686),  # K2 (and K2 bwd's cotangent): 4e8 B
    (10_000, 5000, 0.05970149253731343),  # K1 in the posterior: 2e8 B
])
def test_gram_bounds(rows, cols, ms):
    assert 1e3 * counts.bound_seconds(nbytes=counts.gram_bytes(rows, cols)) == pytest.approx(ms)


def test_a_float64_gram_moves_twice_the_bytes():
    assert counts.gram_bytes(10_000, 10_000, "float64") == 8e8
    # the 3xTF32 product bound beats the bytes' for an n^3/3 product at n = 1e4
    t = counts.bound_seconds(flops=1e12 / 3, nbytes=4e8)
    assert 1e3 * t == pytest.approx(2.0202, abs=1e-4)
