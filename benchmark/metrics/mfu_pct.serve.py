"""The whole request's share of the card's bf16 peak: the request's
model FLOPs (``work.request_flops``) times the window's requests per
second, over 989 TFLOP/s."""

from benchmark.work import PEAK_FLOP_PER_S, request_flops


def read(run):
    if "requests" not in run.window:
        return None
    flops = request_flops(run.cell.config, run.batch)
    per_s = run.window["requests"] / run.window["seconds"]
    return 100.0 * flops * per_s / PEAK_FLOP_PER_S["bfloat16"]
