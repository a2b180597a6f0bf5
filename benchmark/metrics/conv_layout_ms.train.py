"""Ops layer, convolutions: device milliseconds per step in cuDNN's
NCHW <-> NHWC conversion kernels (``layers/conv_layout.txt``)."""


def read(run):
    if "steps" not in run.traced:
        return None
    seconds = run.layer_s("conv_layout")
    return None if seconds is None else seconds * 1e3 / run.traced["steps"]
