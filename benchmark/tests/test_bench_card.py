"""On the card: the tiny cells through the hand kernels, traced, against
the reference. Marked ``gpu``; each test decides whether a card is there.

    python -m pytest -m gpu -p no:xdist -o addopts="" benchmark/tests/test_bench_card.py
"""

import time

import pytest


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_tiny_cell_on_the_card(tiny_bench, cell):
    need_card()
    from benchmark.harness import run_cell

    line = run_cell(tiny_bench, tiny_bench.cell(cell), 2_200_000_003, 0.5, True, "cuda:0",
                    time.perf_counter())
    assert line["correct"], line["checks"]
    device = line["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert 0 < device["busy_s"] <= device["window_s"]
    assert line["metrics"] and line["breakdown"]["device_ops"]
