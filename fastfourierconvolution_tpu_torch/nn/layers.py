"""Building-block modules: inits, BatchNorm, convolutions, SE gate, GELU.

Parameters and BatchNorm state are f32; every layer casts its parameters
to the dtype of the activation it receives. Random initial values come
only from the ``torch.Generator`` passed to ``reset_parameters``.

The port serves in eval mode: a module called in training mode raises,
since batch statistics, noise injection and the FourierUnit's stats
kernel belong to the training slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv as conv_ops

BN_EPS = 1e-5


# Reference init scheme: convs N(0, 0.02), BatchNorm scale N(1, 0.02) and
# bias 0, linear layers U(+-sqrt(1/fan_in)).
def conv_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    w.normal_(0.0, 0.02, generator=generator)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    bound = math.sqrt(1.0 / w.shape[1])  # (out, in): fan_in = in
    w.uniform_(-bound, bound, generator=generator)


def bn_scale_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    w.normal_(1.0, 0.02, generator=generator)


def _require_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} runs in eval mode only; call .eval()"
        )


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with running statistics (eps 1e-5), computed in
    f32 and returned in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            bn_scale_init_(self.weight, generator)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _require_eval(self)
        out = F.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight,
            self.bias, training=False, eps=BN_EPS,
        )
        return out.to(x.dtype)


class Dense(nn.Module):
    """Linear layer computed in the input's dtype; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            dense_init_(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Module):
    """Bias-free 2-D convolution; weight OIHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.stride, self.padding = stride, padding

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            conv_init_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class ConvTranspose2d(nn.Module):
    """Bias-free transposed 2-D convolution; weight IOHW."""

    def __init__(
        self, in_channels, out_channels, kernel_size, stride=1, padding=0,
        output_padding=0,
    ):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            conv_init_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv_transpose2d(
            x, self.weight, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )


class NoiseInjection(nn.Module):
    """StyleGAN-style noise weights, one per channel (zero init).

    Only the parameters exist here: the noise is added in training mode,
    which the serving slice does not run.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()


class SELayer(nn.Module):
    """Squeeze-and-excite gate: mean-pool -> Dense -> ReLU -> Dense ->
    sigmoid -> scale the channels (no biases, hidden max(C // 16, 1))."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = Dense(channels, hidden, bias=False)
        self.fc2 = Dense(hidden, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_ops.global_avg_pool(x)
        y = torch.sigmoid(self.fc2(torch.relu(self.fc1(y))))
        return x * y[:, :, None, None]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: the tanh form for bf16 activations, exact erf otherwise."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "gelu": gelu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "leaky_relu_0.2": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter under ``module`` from ``generator``, in module
    order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
