"""The whole training step's share of the card's bf16 peak: the step's
model FLOPs (``work.train_step_flops``: the reference's convolutions and
products, the FourierUnits' FFT-sized work) times the window's steps per
second, over 989 TFLOP/s."""

from benchmark.work import PEAK_FLOP_PER_S, train_step_flops


def read(run):
    if "steps" not in run.window:
        return None
    flops = train_step_flops(run.cell.config, run.batch)
    per_s = run.window["steps"] / run.window["seconds"]
    return 100.0 * flops * per_s / PEAK_FLOP_PER_S["bfloat16"]
