"""The benchmark's arithmetic on synthetic time stamps."""

import math

import pytest

from portbench import yardstick as ys


def test_percentile_matches_linear_interpolation():
    v = list(range(1, 101))
    assert ys.percentile(v, 50) == pytest.approx(50.5)
    assert ys.percentile(v, 95) == pytest.approx(95.05)
    assert ys.percentile([3.0], 95) == 3.0


def test_gaps_and_rate():
    stamps = [0.0, 10.0, 21.0, 30.0]
    assert ys.gaps(stamps) == [10.0, 11.0, 9.0]


def test_union_counts_overlap_once():
    # two streams: [0, 10) and [5, 15) overlap by 5; [20, 25) apart
    iv = [(0.0, 10.0), (5.0, 15.0), (20.0, 25.0)]
    assert ys.union_length(iv) == 20.0
    assert ys.union_length(iv, 2.0, 22.0) == 15.0
    assert ys.merged(iv, 0.0, 30.0) == [(0.0, 15.0), (20.0, 25.0)]


def test_trace_busy_idle_and_kernel_count_over_two_streams():
    dev = [("k_main", 10.0, 40.0), ("k_side", 20.0, 50.0), ("Memcpy DtoD", 60.0, 70.0),
           ("k_main", 80.0, 90.0)]
    cpu = [("sampler.step", 0.0, 100.0), ("aten::mul", 50.0, 58.0), ("aten::add", 70.0, 79.0)]
    t = ys.Trace(dev, cpu, (0.0, 100.0))
    assert t.busy_s() == pytest.approx(60e-6)  # 40 + 10 + 10, overlap once
    assert t.summed_s() == pytest.approx(80e-6)  # the sum counts the overlap twice
    assert t.window_s == pytest.approx(100e-6)
    assert t.n_kernels() == 3
    assert t.top_ops(2)[0] == ["k_main", pytest.approx(40e-6)]
    gaps = dict(t.idle_gaps())
    assert gaps["sampler.step: aten::mul"] == pytest.approx(10e-6)
    assert gaps["sampler.step: aten::add"] == pytest.approx(10e-6)
    assert gaps["sampler.step: no host op"] == pytest.approx(20e-6)
    assert math.isclose(sum(gaps.values()), 40e-6)
