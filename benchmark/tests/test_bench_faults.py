"""A run with its timed path broken comes out not correct, and so does
the control: the reference in fp8 put in the program's place. On the CPU
at the tiny cells, the run's look for a card skipped, every other part of
a run driven: set-up through the program's own entry points, the window,
the comparison with the reference and the verdict."""

import time

import pytest
import torch

from benchmark.harness import judge, passed, run_cell
from benchmark.reference.ffc_gan import Precision

SEEDS = (2_200_000_001, 3_141_592_653)


def run(bench, cell, seed):
    return run_cell(bench, bench.cell(cell), seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(tiny_bench, seed):
    for cell in ("tiny.train", "tiny.serve"):
        assert run(tiny_bench, cell, seed)["correct"]


@pytest.mark.parametrize("seed", SEEDS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_bench, seed, monkeypatch):
    from fastfourierconvolution_tpu_torch.train.gan import GANTrainer

    monkeypatch.setattr(GANTrainer, "_apply", staticmethod(lambda *args: None))
    line = run(tiny_bench, "tiny.train", seed)
    assert not line["correct"]
    assert line["checks"]["change_median_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_loss_over_half_the_batch_is_caught(tiny_bench, seed, monkeypatch):
    from fastfourierconvolution_tpu_torch.train import gan

    gen_loss, dis_loss = gan.LOSS_PAIRS["hinge"]
    half = lambda t: t[: t.shape[0] // 2]
    monkeypatch.setitem(gan.LOSS_PAIRS, "hinge", (
        lambda fake: gen_loss(half(fake)), lambda fake, real: dis_loss(half(fake), half(real))))
    assert not run(tiny_bench, "tiny.train", seed)["correct"]


@pytest.mark.parametrize("seed", SEEDS)
def test_an_image_altered_where_it_is_produced_is_caught(tiny_bench, seed, monkeypatch):
    from fastfourierconvolution_tpu_torch import serving

    def altered(x):
        out = serving.to_uint8.__wrapped__(x)
        out[0] = 255 - out[0]
        return out

    altered.__wrapped__ = serving.to_uint8
    monkeypatch.setattr(serving, "to_uint8", altered)
    line = run(tiny_bench, "tiny.serve", seed)
    assert not line["correct"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_is_not_correct(tiny_bench, seed):
    from benchmark.drivers import serve as serve_driver
    from benchmark.drivers.train import compare
    from benchmark.harness import driver

    fp8 = Precision("fp8")
    cell = tiny_bench.cell("tiny.train")
    drv = driver(cell, seed, "cpu")
    reference = drv.reference_readings()
    checks = judge(compare(drv.reference_readings(fp8), reference), cell.limits)
    assert not all(passed(c) for c in checks)

    cell = tiny_bench.cell("tiny.serve")
    drv = driver(cell, seed, "cpu")
    drv.setup()
    drv.window(0.2)
    drv.release()
    pairs = [(i, drv.reference_images(serve_driver.latents(drv.cfg, drv.traffic, seed, i), fp8),
              images) for i, images in drv.kept]
    checks = judge(serve_driver.compare(pairs), cell.limits)
    assert not all(passed(c) for c in checks)
    assert torch.is_tensor(pairs[0][1])
