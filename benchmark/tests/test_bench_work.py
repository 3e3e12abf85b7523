"""Bytes, operations and bounds against hand counts at the kernel
table's shapes (one H100: 3.35 TB/s, 67 Top/s f32)."""

import pytest

from benchmark.work import k1, k3, peaks, reduce


def test_k1_flagship_call():
    # 8192 rows x 13 568 samples: tod and mask read, out written, f32
    n = 8192 * 13568
    assert k1.bytes_moved(8192, 13568) == 12 * n
    assert peaks.bound_s(k1.bytes_moved(8192, 13568),
                         k1.ops(8192, 13568)) * 1e3 == pytest.approx(
        0.3981, abs=5e-5)


def test_k3_field_pair_call():
    # R = 4 bands, M = 10 313 728 sorted samples (chunks of 8192), into
    # 2 244 608 pairs
    R, M, chunk, out = 4, 10313728, 8192, 2244608
    hand = 4 * (4 * M + M + M // 8192 + 4 * out)
    assert k3.bytes_moved(R, M, chunk, out) == hand
    assert peaks.bound_s(hand, k3.ops(R, M)) * 1e3 == pytest.approx(
        0.0723, abs=5e-5)


def test_reduction_of_one_observation():
    F, B, C, T, V = 19, 4, 1024, 135704, 256
    n = reduce.bytes_moved(F, B, C, T, V)
    assert n == 4 * F * B * (C * T + C * V + 2 * T)
    assert peaks.bound_s(n) * 1e3 == pytest.approx(12.66, abs=0.01)


def test_bound_takes_the_larger():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 67e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 67e12) == 2.0
