"""Fast Fourier Convolution layers, tuple path (Chi et al., NeurIPS 2020).

The local/global signal is an ``(x_l, x_g)`` tuple of NCHW tensors where
an absent branch is ``None``. Channel splits follow the reference
arithmetic ``c_g = int(c * ratio)``. The spectral re/im channels are
concatenated [re | im], as in the JAX package.

Left out of this slice: the packed-branch mode, the local Fourier unit,
class-conditional BN and spectral norm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops import conv as conv_ops
from ..ops.fourier_unit import fourier_unit_forward
from .layers import (
    ACTIVATIONS,
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    SELayer,
    _require_eval,
    bn_scale_init_,
    conv_init_,
)

Branch = Optional[torch.Tensor]
BranchPair = Tuple[Branch, Branch]


def split_channels(channels: int, ratio: float) -> Tuple[int, int]:
    """(local, global) channel counts."""
    c_g = int(channels * ratio)
    return channels - c_g, c_g


class FourierUnit(nn.Module):
    """rfft2 -> (2C, 2C) mix -> BN (running stats) -> ReLU -> irfft2, as
    one op: the hand-written kernel on CUDA, the plain version on the CPU."""

    def __init__(self, channels: int):
        super().__init__()
        c2 = 2 * channels
        self.mix_kernel = nn.Parameter(torch.empty(c2, c2))
        self.bn_scale = nn.Parameter(torch.empty(c2))
        self.bn_bias = nn.Parameter(torch.empty(c2))
        self.register_buffer("running_mean", torch.zeros(c2))
        self.register_buffer("running_var", torch.ones(c2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            conv_init_(self.mix_kernel, generator)
            bn_scale_init_(self.bn_scale, generator)
            self.bn_bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _require_eval(self)
        return fourier_unit_forward(
            x.contiguous(), self.mix_kernel.to(x.dtype), self.bn_scale,
            self.bn_bias, self.running_mean, self.running_var,
        )


class SpectralTransform(nn.Module):
    """At stride 2 a x2 nearest upsample (``upsample``) or a 2x2 average
    pool; then SE gate, 1x1 conv to C/2 + BN + ReLU, FourierUnit, and a 1x1
    conv back to C on (x + fu(x))."""

    def __init__(
        self, in_channels: int, out_channels: int, stride: int = 1,
        upsample: bool = False,
    ):
        super().__init__()
        half = out_channels // 2
        self.stride, self.upsample = stride, upsample
        self.se = SELayer(in_channels)
        self.conv1 = Conv2d(in_channels, half, 1)
        self.bn = BatchNorm(half)
        self.fu = FourierUnit(half)
        self.conv2 = Conv2d(half, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = (
                conv_ops.upsample_nearest2x(x)
                if self.upsample
                else conv_ops.avg_pool2d(x)
            )
        x = self.se(x)
        x = torch.relu(self.bn(self.conv1(x)))
        return self.conv2(x + self.fu(x))


def _add_opt(a: Branch, b: Branch) -> Branch:
    if a is None:
        return b
    if b is None:
        return a
    return a + b


class FFC(nn.Module):
    """Local/global split with four cross branches: l2l, l2g and g2l are
    k x k convolutions (transposed ones when ``transpose``), g2g is a
    SpectralTransform. A branch with no channels on either side is absent.
    """

    def __init__(
        self, in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
        stride=1, padding=0, output_padding=0, transpose=False,
    ):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        in_cl, in_cg = split_channels(in_channels, ratio_gin)
        out_cl, out_cg = split_channels(out_channels, ratio_gout)
        self.ratio_gout = ratio_gout

        def make_conv(cin, cout):
            if cin == 0 or cout == 0:
                return None
            if transpose:
                return ConvTranspose2d(
                    cin, cout, kernel_size, stride, padding, output_padding
                )
            return Conv2d(cin, cout, kernel_size, stride, padding)

        self.convl2l = make_conv(in_cl, out_cl)
        self.convl2g = make_conv(in_cl, out_cg)
        self.convg2l = make_conv(in_cg, out_cl)
        self.convg2g = None
        if in_cg > 0 and out_cg > 0:
            self.convg2g = SpectralTransform(
                in_cg, out_cg, stride=stride, upsample=transpose
            )

    @staticmethod
    def _run(branch, x):
        if branch is None or x is None:
            return None
        return branch(x)

    def forward(self, x) -> BranchPair:
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        out_l, out_g = None, None
        if self.ratio_gout != 1:
            out_l = _add_opt(self._run(self.convl2l, x_l), self._run(self.convg2l, x_g))
        if self.ratio_gout != 0:
            out_g = _add_opt(self._run(self.convl2g, x_l), self._run(self.convg2g, x_g))
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    """FFC (transposed when ``upsampling``) -> per-branch BN -> activation."""

    def __init__(
        self, in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
        stride=1, padding=0, output_padding=0, norm="identity",
        activation="identity", upsampling=False,
    ):
        super().__init__()
        if norm not in ("batch", "identity"):
            raise ValueError(f"norm must be 'batch' or 'identity', got {norm!r}")
        self.ffc = FFC(
            in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
            stride=stride, padding=padding, output_padding=output_padding,
            transpose=upsampling,
        )
        out_cl, out_cg = split_channels(out_channels, ratio_gout)
        batch = norm == "batch"
        self.bn_l = BatchNorm(out_cl) if batch and out_cl > 0 else None
        self.bn_g = BatchNorm(out_cg) if batch and out_cg > 0 else None
        self.act = ACTIVATIONS[activation]

    def forward(self, x) -> BranchPair:
        x_l, x_g = self.ffc(x)

        def norm_act(v, bn):
            if v is None:
                return None
            return self.act(bn(v) if bn is not None else v)

        return norm_act(x_l, self.bn_l), norm_act(x_g, self.bn_g)


def resize_output(x) -> torch.Tensor:
    """Collapse an FFC tuple to one tensor by concatenating local and
    global channels."""
    if isinstance(x, tuple):
        x_l, x_g = x
        if x_g is None:
            return x_l
        if x_l is None:
            return x_g
        return torch.cat([x_l, x_g], dim=1)
    return x
