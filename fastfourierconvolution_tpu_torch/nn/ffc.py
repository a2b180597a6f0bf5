"""Fast Fourier Convolution layers (Chi et al., NeurIPS 2020).

Two execution modes with the same modules and parameter names:

- tuple path: the local/global signal is an ``(x_l, x_g)`` tuple of NCHW
  tensors where an absent branch is ``None``;
- packed-branch mode (``packed=True``): one ``Packed(x, cl)`` map with the
  local channels first. The three conv branches run as one convolution
  with a block-structured kernel (zero g→g block; the SpectralTransform
  adds that part), and BN + activation run once over the whole map with
  per-channel statistics, which equal the per-branch ones. In training with
  the tanh-form GELU that pass is the fused op of ``ops/bn_act.py``, with
  the generator's noise injection folded in.

Channel splits follow the reference arithmetic ``c_g = int(c * ratio)``.
The spectral re/im channels are concatenated [re | im], as in the JAX
package.

Class-conditional BN: with ``num_classes`` > 1 an FFC_BN_ACT normalises
each branch with a :class:`ConditionalBatchNorm` on the labels it is
given; with ``cond_spectral_bn`` too, its FourierUnit takes the
conditional path (plain rfft2 -> mix -> ConditionalBatchNorm -> ReLU ->
irfft2, as the JAX package computes it outside any kernel). The tuple path
only.

Left out so far: the local Fourier unit and spectral norm inside the FFC
layers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import conv as conv_ops
from ..ops.bn_act import packed_bn_gelu, packed_bn_gelu_noise
from ..ops.fourier import irfft2_ortho
from ..ops.fourier_unit import _spectrum_plain, fourier_unit_eval, fourier_unit_train
from .layers import (
    ACTIVATIONS,
    BN_EPS,
    BatchNorm,
    ConditionalBatchNorm,
    Conv2d,
    ConvTranspose2d,
    SELayer,
    bn_scale_init_,
    conv_init_,
    gelu_is_fast,
    update_running_,
)

Branch = Optional[torch.Tensor]
BranchPair = Tuple[Branch, Branch]


class Packed(NamedTuple):
    """Packed-branch signal: ``x`` (B, cl + cg, H, W), local channels
    first; ``cl`` the local channel count."""

    x: torch.Tensor
    cl: int


def noise_add(x: torch.Tensor, cl: int, w, n_l, n_g) -> torch.Tensor:
    """x + T(w)·n in x's dtype, n = n_l (B, 1, H, W) on the channels below
    ``cl`` and n_g from ``cl`` on; ``w`` (C,) f32."""
    wt = w.to(x.dtype)[:, None, None]
    return torch.cat([x[:, :cl] + wt[:cl] * n_l, x[:, cl:] + wt[cl:] * n_g], dim=1)


def split_channels(channels: int, ratio: float) -> Tuple[int, int]:
    """(local, global) channel counts."""
    c_g = int(channels * ratio)
    return channels - c_g, c_g


class FourierUnit(nn.Module):
    """rfft2 -> (2C, 2C) mix -> BN -> ReLU -> irfft2, as one op: the
    hand-written kernels on CUDA, the plain versions on the CPU. Eval
    normalises with the running statistics; training with the f32 batch
    statistics, which then update the running ones (momentum 0.9, biased
    variance). With ``num_classes`` > 1 the BN is a
    :class:`ConditionalBatchNorm` (``bn``) on the labels, in plain ops."""

    def __init__(self, channels: int, num_classes: int = 0):
        super().__init__()
        c2 = 2 * channels
        self.mix_kernel = nn.Parameter(torch.empty(c2, c2))
        if num_classes > 1:
            self.bn = ConditionalBatchNorm(c2, num_classes)
            return
        self.bn = None
        self.bn_scale = nn.Parameter(torch.empty(c2))
        self.bn_bias = nn.Parameter(torch.empty(c2))
        self.register_buffer("running_mean", torch.zeros(c2))
        self.register_buffer("running_var", torch.ones(c2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            conv_init_(self.mix_kernel, generator)
            if self.bn is not None:
                return
            bn_scale_init_(self.bn_scale, generator)
            self.bn_bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bn is not None:
            if y is None:
                raise ValueError("a class-conditional FourierUnit needs labels")
            c, h, w = x.shape[1:]
            _, m = _spectrum_plain(x, self.mix_kernel.to(x.dtype))
            r = torch.relu(self.bn(m, y))
            return irfft2_ortho(r[:, :c], r[:, c:], (h, w))
        x, kernel = x.contiguous(), self.mix_kernel.to(x.dtype)
        if not self.training:
            return fourier_unit_eval(
                x, kernel, self.bn_scale, self.bn_bias, self.running_mean,
                self.running_var,
            )
        y, bmean, bvar = fourier_unit_train(x, kernel, self.bn_scale, self.bn_bias)
        update_running_(self.running_mean, bmean)
        update_running_(self.running_var, bvar)
        return y


class SpectralTransform(nn.Module):
    """At stride 2 a x2 nearest upsample (``upsample``) or a 2x2 average
    pool; then SE gate, 1x1 conv to C/2 + BN + ReLU, FourierUnit, and a 1x1
    conv back to C on (x + fu(x))."""

    def __init__(
        self, in_channels: int, out_channels: int, stride: int = 1,
        upsample: bool = False, num_classes: int = 0,
    ):
        super().__init__()
        half = out_channels // 2
        self.stride, self.upsample = stride, upsample
        self.se = SELayer(in_channels)
        self.conv1 = Conv2d(in_channels, half, 1)
        self.bn = BatchNorm(half)
        self.fu = FourierUnit(half, num_classes)
        self.conv2 = Conv2d(half, out_channels, 1)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.stride == 2:
            x = (
                conv_ops.upsample_nearest2x(x)
                if self.upsample
                else conv_ops.avg_pool2d(x)
            )
        x = self.se(x)
        x = torch.relu(self.bn(self.conv1(x)))
        return self.conv2(x + self.fu(x, y))


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
    With ``use_bias`` the l2l, l2g and g2l convolutions carry a bias (the
    SpectralTransform's stay bias-free); the tuple path's plain
    convolutions only. ``spectral_classes`` > 1 makes the g2g branch's
    FourierUnit class-conditional.
    """

    def __init__(
        self, in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
        stride=1, padding=0, output_padding=0, transpose=False, packed=False,
        use_bias=False, spectral_classes=0,
    ):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        if use_bias and (transpose or packed):
            raise ValueError("a conv bias is taken by the tuple path's plain convolutions only")
        in_cl, in_cg = split_channels(in_channels, ratio_gin)
        out_cl, out_cg = split_channels(out_channels, ratio_gout)
        self.ratio_gout = ratio_gout
        self.in_split, self.out_split = (in_cl, in_cg), (out_cl, out_cg)
        self.kernel_size, self.transpose, self.packed = kernel_size, transpose, packed
        self.conv_args = dict(stride=stride, padding=padding)
        if transpose:
            self.conv_args["output_padding"] = output_padding

        def make_conv(cin, cout):
            if cin == 0 or cout == 0:
                return None
            if transpose:
                return ConvTranspose2d(
                    cin, cout, kernel_size, stride, padding, output_padding
                )
            return Conv2d(cin, cout, kernel_size, stride, padding, bias=use_bias)

        self.convl2l = make_conv(in_cl, out_cl)
        self.convl2g = make_conv(in_cl, out_cg)
        self.convg2l = make_conv(in_cg, out_cl)
        self.convg2g = None
        if in_cg > 0 and out_cg > 0:
            self.convg2g = SpectralTransform(
                in_cg, out_cg, stride=stride, upsample=transpose,
                num_classes=spectral_classes,
            )

    @staticmethod
    def _run(branch, x):
        if branch is None or x is None:
            return None
        return branch(x)

    def block_kernel(self) -> torch.Tensor:
        """The three conv branches as one kernel over the packed channels:
        OIHW (IOHW when transposed), input rows / output columns ordered
        [local | global], the g→g block zero."""
        (in_cl, in_cg), (out_cl, out_cg) = self.in_split, self.out_split
        k = self.kernel_size
        zero = self.convg2g.conv1.weight.new_zeros(
            (in_cg, out_cg, k, k) if self.transpose else (out_cg, in_cg, k, k)
        ) if self.convg2g is not None else None
        # convs[i][o]: the branch from input side i to output side o
        convs = [[self.convl2l, self.convl2g], [self.convg2l, None]]
        blocks = [
            [convs[i][o].weight if convs[i][o] is not None else zero
             for o, n_out in enumerate((out_cl, out_cg)) if n_out > 0]
            for i, n_in in enumerate((in_cl, in_cg)) if n_in > 0
        ]
        in_dim, out_dim = (0, 1) if self.transpose else (1, 0)
        return torch.cat([torch.cat(row, dim=out_dim) for row in blocks], dim=in_dim)

    def _packed_forward(self, p: Packed) -> Packed:
        (in_cl, in_cg), (out_cl, out_cg) = self.in_split, self.out_split
        x = p.x
        if p.cl != in_cl or x.shape[1] != in_cl + in_cg:
            raise ValueError(
                f"packed input has cl={p.cl}, C={x.shape[1]}; expected "
                f"({in_cl}, {in_cl + in_cg})"
            )
        conv = conv_ops.conv_transpose2d if self.transpose else conv_ops.conv2d
        out = conv(x, self.block_kernel(), **self.conv_args)
        if self.convg2g is not None:
            s = self.convg2g(x[:, in_cl:])
            out = torch.cat([out[:, :out_cl], out[:, out_cl:] + s], dim=1) if out_cl else out + s
        return Packed(out, out_cl)

    def forward(self, x, y=None):
        """``y``: the labels of a class-conditional FourierUnit."""
        if self.packed:
            if not isinstance(x, Packed):
                raise TypeError("a packed FFC takes a Packed signal")
            return self._packed_forward(x)
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        out_l, out_g = None, None
        if self.ratio_gout != 1:
            out_l = _add_opt(self._run(self.convl2l, x_l), self._run(self.convg2l, x_g))
        if self.ratio_gout != 0:
            g2g = None if self.convg2g is None or x_g is None else self.convg2g(x_g, y)
            out_g = _add_opt(self._run(self.convl2g, x_l), g2g)
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    """FFC (transposed when ``upsampling``; ``use_bias`` as in :class:`FFC`)
    -> per-branch BN -> activation; with ``packed``, on a ``Packed`` signal
    (see the module docstring). With ``num_classes`` > 1 the BNs are
    class-conditional and, with ``cond_spectral_bn``, so is the
    FourierUnit's; the forward then takes the labels."""

    def __init__(
        self, in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
        stride=1, padding=0, output_padding=0, norm="identity",
        activation="identity", upsampling=False, packed=False, use_bias=False,
        num_classes=0, cond_spectral_bn=False,
    ):
        super().__init__()
        if norm not in ("batch", "identity"):
            raise ValueError(f"norm must be 'batch' or 'identity', got {norm!r}")
        if packed and num_classes > 1:
            raise ValueError("packed mode does not take class-conditional BN")
        self.ffc = FFC(
            in_channels, out_channels, kernel_size, ratio_gin, ratio_gout,
            stride=stride, padding=padding, output_padding=output_padding,
            transpose=upsampling, packed=packed, use_bias=use_bias,
            spectral_classes=num_classes if cond_spectral_bn else 0,
        )
        out_cl, out_cg = split_channels(out_channels, ratio_gout)
        self.conditional = num_classes > 1
        if norm == "identity":
            make_bn = lambda c: None
        elif self.conditional:
            make_bn = lambda c: ConditionalBatchNorm(c, num_classes)
        else:
            make_bn = BatchNorm
        self.bn_l = make_bn(out_cl) if out_cl > 0 else None
        self.bn_g = make_bn(out_cg) if out_cg > 0 else None
        self.activation, self.packed = activation, packed
        self.act = ACTIVATIONS[activation]

    def forward(self, x, y=None, noise_fold=None):
        """``y``: the labels (B,) of a class-conditional block.
        ``noise_fold``: optional ``(w, n_l, n_g)`` of a packed block, the
        generator's noise injection applied in the norm-act pass (w (C,)
        f32, n_l and n_g (B, 1, H, W) in x's dtype)."""
        if self.packed:
            return self._packed_norm_act(self.ffc(x), noise_fold)
        if noise_fold is not None:
            raise ValueError("noise_fold needs packed mode")
        if self.conditional and y is None:
            raise ValueError("a class-conditional block needs labels")
        x_l, x_g = self.ffc(x, y)

        def norm_act(v, bn):
            if v is None:
                return None
            if bn is None:
                return self.act(v)
            return self.act(bn(v, y) if self.conditional else bn(v))

        return norm_act(x_l, self.bn_l), norm_act(x_g, self.bn_g)

    def _packed_norm_act(self, p: Packed, noise_fold) -> Packed:
        """BN and the activation over the whole packed map: the fused op in
        training with the tanh-form GELU; otherwise batch statistics (f32,
        E[x²] − E[x]², no clamp) or the running ones, normalised in f32 and
        cast to x's dtype before the activation."""
        arr, cl = p

        def add_noise(out):
            return out if noise_fold is None else noise_add(out, cl, *noise_fold)

        bns = [bn for bn in (self.bn_l, self.bn_g) if bn is not None]
        if not bns:
            return Packed(add_noise(self.act(arr)), cl)
        scale = torch.cat([bn.weight for bn in bns])
        bias = torch.cat([bn.bias for bn in bns])
        if self.training and self.activation == "gelu" and gelu_is_fast(arr.dtype):
            if noise_fold is not None and cl > 0:
                out, mean, var = packed_bn_gelu_noise(arr, scale, bias, *noise_fold, cl)
            else:
                out, mean, var = packed_bn_gelu(arr, scale, bias)
                out = add_noise(out)
            self._update_running(bns, mean, var)
            return Packed(out, cl)
        if self.training:
            xf = arr.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
            self._update_running(bns, mean, var)
        else:
            mean = torch.cat([bn.running_mean for bn in bns])
            var = torch.cat([bn.running_var for bn in bns])
        isc = torch.rsqrt(var + BN_EPS) * scale
        out = ((arr.float() - mean[:, None, None]) * isc[:, None, None]
               + bias[:, None, None]).to(arr.dtype)
        return Packed(add_noise(self.act(out)), cl)

    @staticmethod
    def _update_running(bns, mean, var):
        for bn, m, v in zip(bns, mean.split([bn.weight.numel() for bn in bns]),
                            var.split([bn.weight.numel() for bn in bns])):
            bn.update_running_stats_(m.detach(), v.detach())


def resize_output(x) -> torch.Tensor:
    """Collapse an FFC signal to one tensor: a ``Packed`` map as it is, a
    tuple by concatenating local and global channels."""
    if isinstance(x, Packed):
        return x.x
    if isinstance(x, tuple):
        x_l, x_g = x
        if x_g is None:
            return x_l
        if x_l is None:
            return x_g
        return torch.cat([x_l, x_g], dim=1)
    return x
