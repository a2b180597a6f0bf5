"""Kernels layer, FourierUnit, serving: the least time a request's
FourierUnit eval forwards need (``work.bound`` at bf16) over the device
time of the kernels that ``layers/fourier_unit.txt`` lists, per request of
the traced window."""

from benchmark.shapes import fourier_unit_calls
from benchmark.work import calls_bound_ms


def read(run):
    if "requests" not in run.traced:
        return None
    seconds = run.layer_s("fourier_unit")
    if seconds is None:
        return None
    bound_ms = calls_bound_ms(fourier_unit_calls(run.cell.config, run.batch, False), 2,
                              "bfloat16")
    return 100.0 * bound_ms / (seconds * 1e3 / run.traced["requests"])
