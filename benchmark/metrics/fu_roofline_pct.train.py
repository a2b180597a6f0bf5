"""Kernels layer, FourierUnit, training: the least time the step's
FourierUnit work needs (two training forwards and one backward at each of
the generator's FourierUnit maps, ``work.bound`` of the function at bf16)
over the device time of the kernels that ``layers/fourier_unit.txt``
lists, per step of the traced call."""

from benchmark.shapes import fourier_unit_calls
from benchmark.work import calls_bound_ms


def read(run):
    if "steps" not in run.traced:
        return None
    seconds = run.layer_s("fourier_unit")
    if seconds is None:
        return None
    bound_ms = calls_bound_ms(fourier_unit_calls(run.cell.config, run.batch, True), 2,
                              "bfloat16")
    return 100.0 * bound_ms / (seconds * 1e3 / run.traced["steps"])
