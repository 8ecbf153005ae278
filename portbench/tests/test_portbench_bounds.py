"""The frozen bounds, each worked once by hand."""

import pytest

from portbench.bounds import k1_classic, k8_chain, peaks
from portbench.reference import rng


def test_peaks():
    assert peaks.ALU_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    assert peaks.ALU_OPS_PER_S == pytest.approx(1.6727e13, rel=1e-4)


def test_threefry_has_twenty_rotating_rounds():
    assert sum(len(r) for r in rng.ROTATIONS) * 5 // 2 == k1_classic.ROUNDS


def test_k1_by_hand():
    # 1,000 packets, 25,000 events: 40 ALU operations a hash, one hash a
    # packet, two an event plus one comparison of the search
    w = k1_classic.work(1000, 25000)
    assert w["alu_ops"] == 40 * 1000 + (2 * 40 + 1) * 25000 == 2_065_000
    assert w["bytes"] == 1000 * (8 + 8 + 24)
    t = k1_classic.bound_s(1000, 25000)
    assert t == pytest.approx(2_065_000 / (132 * 64 * 1.98e9))
    # the ALU term bounds it: 40 kB at 3.35 TB/s is 12 ns
    assert 40_000 / 3.35e12 < t


def test_k1_bytes_bound_a_packet_without_events():
    t = k1_classic.bound_s(10**9, 0)
    assert t == pytest.approx(max(40e9 / peaks.ALU_OPS_PER_S,
                                  40e9 / 3.35e12))


def test_k8_by_hand():
    # the tardis_example build: 18 groups of 200 levels, jumps of at most
    # 60 levels, 20 shells, 183,060 lines, 3,600 levels, W 200, We 60
    groups = [200] * 18
    w = k8_chain.work(groups, 60, 20, 183_060, 3600, 200, 60)
    assert w["flops"] == 20 * 18 * 2 * 200 * 200 * 60 == 1_728_000_000
    read = 3 * 8 * 183_060 * 20
    written = 4 * 20 * 3600 * (201 + 180)
    assert w["bytes"] == read + written == 197_596_800
    t = k8_chain.bound_s(groups, 60, 20, 183_060, 3600, 200, 60)
    # bytes bound it: 197.7 MB at 3.35 TB/s = 59.0 us (flops: 25.8 us)
    assert t == pytest.approx(197_596_800 / 3.35e12)
    assert 1.728e9 / 67e12 < t


def test_k8_below_gauss_jordan():
    # 2 n^2 b never passes K8's own 2 n^3, so a share stays under 100%
    w = k8_chain.work([200, 37], 500, 1, 1, 1, 1, 1)
    assert w["flops"] == 2 * 200**3 + 2 * 37**3


def test_k1_continuum_by_hand():
    from portbench.bounds import k1_continuum

    # 1,048,576 packets, 25,954,955 events (a final IIP iteration), 159
    # grid cells, 20 shells
    w = k1_continuum.work(1_048_576, 25_954_955, 159, 20)
    assert w["alu_ops"] == 40 * 1_048_576 + 81 * 25_954_955
    assert w["bytes"] == 44 * 1_048_576 + 64 * 159 * 20
    t = k1_continuum.bound_s(1_048_576, 25_954_955, 159, 20)
    assert t == pytest.approx((40 * 1_048_576 + 81 * 25_954_955)
                              / (132 * 64 * 1.98e9))
