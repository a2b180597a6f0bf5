"""Kernels layer, fused BN + GELU, training: the least time the step's
fused BN work needs (at each block's packed map the statistics and the
apply with the noise fold twice, the backward sums and dx once;
``work.bound``, bf16 maps, f32 arithmetic) over the device time of the
kernels that ``layers/fused_bn.txt`` lists, per step. Nothing to read
where the generator runs BN as plain ops (the tuple path)."""

from benchmark.shapes import fused_bn_calls
from benchmark.work import calls_bound_ms


def read(run):
    if "steps" not in run.traced:
        return None
    seconds = run.layer_s("fused_bn")
    if seconds is None:
        return None
    bound_ms = calls_bound_ms(fused_bn_calls(run.cell.config, run.batch), 2, "bfloat16")
    return 100.0 * bound_ms / (seconds * 1e3 / run.traced["steps"])
