"""Building-block modules: inits, BatchNorm and its class-conditional form,
label embeddings, convolutions, spectral-normed layers (transposed
convolution included), noise injection, input noise, SE gate, SAGAN
self-attention, GELU.

Parameters, BatchNorm state and spectral-norm ``u`` vectors are f32;
every layer casts its parameters to the dtype of the activation it
receives. Random values come only from ``torch.Generator``s the caller
passes: initial values from the one given to ``reset_parameters``, noise
from the one given to the model's forward.

Training mode follows the JAX package (flax semantics): BatchNorm
normalises with f32 batch statistics and the biased variance, and
updates its running statistics as ``0.9 * running + 0.1 * batch``, also
with the biased variance (torch's ``F.batch_norm`` would store the
unbiased one); a spectral-normed layer runs one power iteration per
forward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv as conv_ops
from ..ops.spectral_norm import l2_normalize, spectral_normalize

BN_EPS = 1e-5
# Weight of the old running statistic: flax momentum 0.9 (torch 0.1).
BN_MOMENTUM = 0.9


# Reference init scheme: convs N(0, 0.02), BatchNorm scale N(1, 0.02) and
# bias 0, linear layers U(+-sqrt(1/fan_in)).
def conv_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    w.normal_(0.0, 0.02, generator=generator)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    bound = math.sqrt(1.0 / w.shape[1])  # (out, in): fan_in = in
    w.uniform_(-bound, bound, generator=generator)


def bn_scale_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    w.normal_(1.0, 0.02, generator=generator)


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator, gain: float = 1.0) -> None:
    """U(+-gain * sqrt(6 / (fan_in + fan_out))): the JAX package's
    ``variance_scaling(gain**2, "fan_avg", "uniform")`` (the SNGAN-ResNet
    models' inits, gain sqrt(2) or 1)."""
    nn.init.xavier_uniform_(w, gain=gain, generator=generator)


def update_running_(running: torch.Tensor, batch: torch.Tensor) -> None:
    """running <- 0.9 * running + 0.1 * batch, in place, outside the graph."""
    with torch.no_grad():
        running.mul_(BN_MOMENTUM).add_(batch, alpha=1.0 - BN_MOMENTUM)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (eps 1e-5), computed in f32 and returned in the
    input's dtype: batch statistics in training (mean and biased variance
    E[x²] − E[x]² over (B, H, W), clipped at 0), running statistics in
    eval."""

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

    def update_running_stats_(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold batch statistics computed by the caller into the running
        ones (the packed-branch path computes them over the packed map)."""
        update_running_(self.running_mean, mean)
        update_running_(self.running_var, var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            out = F.batch_norm(
                xf, self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=BN_EPS,
            )
            return out.to(x.dtype)
        mean, var = batch_stats_(self, xf)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        out = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return out.to(x.dtype)


def batch_stats_(bn: nn.Module, xf: torch.Tensor):
    """(mean, biased variance E[x²] − E[x]² clipped at 0) of the f32 map
    ``xf`` over (B, H, W), folded into ``bn``'s running statistics."""
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    update_running_(bn.running_mean, mean)
    update_running_(bn.running_var, var)
    return mean, var


class ConditionalBatchNorm(nn.Module):
    """Class-conditional BatchNorm over dim 1: BatchNorm without affine
    parameters (statistics as :class:`BatchNorm`'s, in f32), then
    ``gamma[y] * out + beta[y]`` from per-class tables (gamma init
    N(1, 0.02), beta 0), returned in the input's dtype."""

    def __init__(self, channels: int, num_classes: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(num_classes, channels))
        self.beta = nn.Parameter(torch.empty(num_classes, channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            bn_scale_init_(self.gamma, generator)
            self.beta.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x (B, C, ...) and labels y (B,) integers."""
        xf = x.float()
        if self.training:
            mean, var = batch_stats_(self, xf)
        else:
            mean, var = self.running_mean, self.running_var
        tail = (None,) * (x.dim() - 2)
        out = (xf - mean[(..., *tail)]) * torch.rsqrt(var + BN_EPS)[(..., *tail)]
        gamma, beta = self.gamma[y][(..., *tail)], self.beta[y][(..., *tail)]
        return (gamma * out + beta).to(x.dtype)


class LabelEmbedding(nn.Module):
    """A (num_classes, dim) table of label vectors, N(0, 1) init; returns
    ``weight[y]``."""

    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.weight[y]


class Dense(nn.Module):
    """Linear layer computed in the input's dtype; weight (out, in). The
    bias is added to the rounded product, as flax's Dense adds it (in
    bf16 a fused add would round once where flax rounds twice)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init: Callable = dense_init_):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.weight_init = weight_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight_init(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)


class Conv2d(nn.Module):
    """2-D convolution, bias-free unless ``bias`` (zero init); weight
    OIHW, drawn by ``weight_init``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 bias: bool = False, weight_init: Callable = conv_init_):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding = stride, padding
        self.weight_init = weight_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight_init(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_ops.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class ConvTranspose2d(nn.Module):
    """Transposed 2-D convolution, bias-free unless ``bias`` (zero init,
    added to the output in its dtype); weight IOHW."""

    def __init__(
        self, in_channels, out_channels, kernel_size, stride=1, padding=0,
        output_padding=0, bias: bool = False,
    ):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            conv_init_(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_ops.conv_transpose2d(
            x, self.weight, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


def draw_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) single-channel noise (B, 1, H, W) for ``x`` (B, C, H, W), in
    x's dtype, on x's device, from ``generator``."""
    b, _, h, w = x.shape
    return torch.randn((b, 1, h, w), generator=generator, device=x.device, dtype=x.dtype)


class NoiseInjection(nn.Module):
    """StyleGAN-style noise: ``x + weight[c] * noise`` with one weight per
    channel (zero init) and ``noise`` (B, 1, H, W) in x's dtype. The model
    applies it in training only."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight.to(x.dtype)[None, :, None, None] * noise


class GaussianNoise(nn.Module):
    """Input-noise regulariser: ``x + stddev * N(0, 1)`` drawn in x's dtype
    from ``generator``, in training only."""

    def __init__(self, stddev: float = 0.05):
        super().__init__()
        self.stddev = stddev

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.stddev == 0.0:
            return x
        if generator is None:
            raise ValueError("a training forward with input noise needs a noise generator")
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return x + self.stddev * noise


class _SpectralNormed(nn.Module):
    """Holds ``weight``, drawn by ``weight_init``, ``bias`` of
    ``out_features`` (unless ``bias`` is False) and the power iteration's
    ``u`` buffer (unit norm at init) over the weight's first dimension,
    the rows of ``matrix_view``."""

    def __init__(self, weight_shape, out_features: int, bias: bool, weight_init: Callable):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.register_buffer("u", torch.empty(weight_shape[0]))
        self.weight_init = weight_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight_init(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self.u.copy_(l2_normalize(torch.randn(self.u.shape, generator=generator)))

    def normalized_weight(self) -> torch.Tensor:
        """weight / sigma; in training the new u is copied into the buffer
        (the graph keeps its own tensor)."""
        w, u_new = spectral_normalize(self.weight, self.u, update=self.training)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u_new)
        return w


class SNConv2d(_SpectralNormed):
    """Spectral-normalised 2-D convolution, with a bias unless ``bias`` is
    False; weight OIHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 bias: bool = True, weight_init: Callable = conv_init_):
        k = kernel_size
        super().__init__((out_channels, in_channels, k, k), out_channels, bias, weight_init)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_ops.conv2d(x, self.normalized_weight(), stride=self.stride,
                            padding=self.padding)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class SNDense(_SpectralNormed):
    """Spectral-normalised linear layer with bias, added to the rounded
    product as in the JAX package; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_init: Callable = dense_init_):
        super().__init__((out_features, in_features), out_features, True, weight_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.normalized_weight().to(x.dtype))
        return y + self.bias.to(y.dtype)


class SNConvTranspose2d(_SpectralNormed):
    """Spectral-normalised transposed 2-D convolution (the SAGAN
    generator's), with a bias unless ``bias`` is False; weight IOHW. As in
    the JAX package (and torch's ``spectral_norm`` on a transposed
    convolution) the matrix has the INPUT channels as rows, so ``u`` has
    ``in_channels`` entries: ``matrix_view`` takes the weight's first
    dimension as rows, which is cin in this layout. The bridge's spatial
    flip permutes columns only, so sigma and ``u`` carry over."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, bias: bool = True):
        k = kernel_size
        super().__init__((in_channels, out_channels, k, k), out_channels, bias, conv_init_)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_ops.conv_transpose2d(
            x, self.normalized_weight(), stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


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


class SelfAttention(nn.Module):
    """SAGAN self-attention over (B, C, H, W): q and k are biased 1x1
    convolutions to C // 8 channels, v one to C; ``energy = q kᵀ`` over
    the N = H·W positions is accumulated and returned in f32 (the bf16
    operands upcast, which is exact, as the JAX package asks for an f32
    product), the softmax over keys in f32; ``attn`` is cast to x's dtype
    for the product with v, accumulated in f32 and rounded once. Returns
    ``(gamma * out + x, attn)``, with ``gamma`` a scalar that starts at 0
    and ``attn`` (B, N, N) f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.query = Conv2d(channels, channels // 8, 1, bias=True)
        self.key = Conv2d(channels, channels // 8, 1, bias=True)
        self.value = Conv2d(channels, channels, 1, bias=True)
        self.gamma = nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x: torch.Tensor):
        b, c, h, w = x.shape
        q = self.query(x).flatten(2).transpose(1, 2)  # (B, N, C/8)
        k = self.key(x).flatten(2)  # (B, C/8, N)
        v = self.value(x).flatten(2).transpose(1, 2)  # (B, N, C)
        attn = torch.softmax(torch.bmm(q.float(), k.float()), dim=-1)
        out = torch.bmm(attn.to(x.dtype), v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x, attn


# GELU form: "policy" takes the tanh form for bf16 activations and exact erf
# otherwise, as the JAX package does; True / False force the tanh / erf
# form for every dtype (the f32 checks of the fused packed BN+GELU op, which
# runs only where the tanh form applies, force it).
_FAST_GELU = "policy"


def set_fast_gelu(mode) -> None:
    """mode: "policy", True (tanh form) or False (exact erf)."""
    global _FAST_GELU
    if mode not in ("policy", True, False):
        raise ValueError(f"fast-GELU mode must be 'policy', True or False, got {mode!r}")
    _FAST_GELU = mode


def gelu_is_fast(dtype: torch.dtype) -> bool:
    """Whether :func:`gelu` takes the tanh form for ``dtype``."""
    if _FAST_GELU == "policy":
        return dtype == torch.bfloat16
    return _FAST_GELU


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the form :func:`gelu_is_fast` picks for x's dtype."""
    return F.gelu(x, approximate="tanh" if gelu_is_fast(x.dtype) else "none")


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
