"""The device trace's arithmetic: union, gaps, labels, shares."""

from pytest import approx

import pytest

from benchmark.trace import Trace, gaps, traced_window, union


def test_union_merges_and_clips():
    assert union([(5, 9), (0, 3), (2, 4), (8, 12)], (1, 10)) == [(1, 4), (5, 10)]


def test_gaps_of_the_window():
    assert gaps([(1, 4), (5, 10)], (0, 12)) == [(0, 1), (4, 5), (10, 12)]


def test_busy_idle_labels_and_layer_time():
    trace = Trace(kernels=[("k_a", 10, 30), ("k_b", 20, 40), ("fu_x", 60, 70)],
                  spans=[("request", 0, 100), ("generate", 0, 50), ("to_host", 50, 100)],
                  window=(0, 100))
    assert trace.busy_s == approx(40e-6)
    assert trace.window_s == approx(100e-6)
    assert trace.kernel_s(["fu_"]) == approx(10e-6)
    assert [n for n, _ in trace.idle_gaps()] == ["to_host", "generate"]
    assert [t for _, t in trace.idle_gaps()] == approx([50e-6, 10e-6])
    assert trace.device_ops()[0] == ["k_a", approx(20e-6)]
    assert trace.label(200) == "outside spans"


def test_the_window_opens_at_the_marker():
    kernels = [("lead", 0, 50), ("spin_kernel", 50, 51), ("k", 51, 90)]
    spans = [("update_steps", 20, 25), ("synchronize", 25, 95)]
    assert traced_window(kernels, spans) == (20, 95)
    window = traced_window(kernels, spans, "spin_kernel")
    assert window == (51, 95)
    trace = Trace(kernels, spans, window)
    assert trace.busy_s == approx(39e-6)
    assert trace.kernel_s(["lead", "spin"]) == 0
    with pytest.raises(RuntimeError):
        traced_window(kernels[:1], spans, "spin_kernel")
