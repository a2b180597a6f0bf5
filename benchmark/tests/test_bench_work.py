"""The frozen work counts: values the port's kernel table prints, and the
whole step's and request's FLOPs from the reference on the meta device."""

import json

import pytest

from benchmark import shapes, work
from conftest import ROOT


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_fourier_unit_forward_bound_at_256px_plane():
    ms, by, nbytes, _ = work.bound("fourier_unit_fwd", (64, 32, 256, 256), 2, "bfloat16")
    assert by == "bytes"
    assert nbytes == 536_880_128
    assert ms == pytest.approx(0.16026, abs=5e-6)


def test_bn_stats_bound_at_128px_packed_map():
    ms, by, nbytes, flops = work.bound("bn_stats", (64, 128, 128, 128), 2, "bfloat16")
    assert (by, nbytes, flops) == ("bytes", 268_436_480, 402_653_184)
    assert ms == pytest.approx(0.08013, abs=5e-6)


@pytest.mark.parametrize("name, maps", [
    ("fgan128", [(64, 64, 16, 16), (64, 32, 32, 32), (64, 32, 64, 64), (64, 32, 128, 128)]),
    ("fgan32", [(64, 16, 16, 16), (64, 8, 32, 32)]),
])
def test_fourier_unit_maps_are_the_kernel_tables(name, maps):
    assert shapes.fourier_unit_maps(config(name), 64) == maps


def test_packed_maps_of_fgan128():
    assert shapes.block_maps(config("fgan128"), 64) == [
        (64, 512, 8, 8), (64, 256, 16, 16), (64, 128, 32, 32), (64, 128, 64, 64),
        (64, 128, 128, 128)]


@pytest.mark.parametrize("name, step_tflop, request_tflop", [
    ("fgan128", 2.926729428992, 0.201028796416),
    ("fgan32", 0.162342223872, 0.012889473024),
])
def test_model_flops(name, step_tflop, request_tflop):
    cfg = config(name)
    assert work.train_step_flops(cfg, 64) / 1e12 == pytest.approx(step_tflop, rel=1e-9)
    assert work.request_flops(cfg, 64) / 1e12 == pytest.approx(request_tflop, rel=1e-9)


def test_step_counts_each_fourier_unit_twice_forward_once_backward():
    calls = shapes.fourier_unit_calls(config("fgan32"), 64, train=True)
    assert [k for k, *_ in calls] == ["train_forward", "train_forward", "train_backward"] * 2
