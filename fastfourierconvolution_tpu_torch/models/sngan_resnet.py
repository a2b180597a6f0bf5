"""SNGAN-ResNet models, the JAX package's ``models/sngan_resnet.py``.

- :class:`GBlock`: BN -> ReLU -> [bilinear x2] -> SN conv3x3 -> BN -> ReLU
  -> SN conv3x3, plus a shortcut: an SN 1x1 conv after the upsample where
  the shape changes, else the input. With ``num_classes > 0`` its BNs are
  class-conditional and the block takes labels.
- :class:`DBlock`: ReLU -> SN conv3x3 -> ReLU -> SN conv3x3 [-> 2x2 average
  pool], plus an SN 1x1 shortcut [then the pool] where the shape changes;
  :class:`DBlockOptimized`, the stem, pools in both paths, its shortcut's
  pool before the 1x1.
- :class:`SNGANGenerator`: a dense stem (f32, as flax's Dense promotes to
  its parameters) to (bottom, bottom, ngf) laid out NHWC, ``num_blocks``
  upsampling GBlocks (channels halving each block on the 5-block 128px
  ladder, ngf throughout otherwise), BN, ReLU, a biased conv3x3 to RGB that
  is NOT spectral-normed, tanh.
- :class:`SNGANDiscriminator`: a DBlockOptimized stem, downsampling
  DBlocks, a last DBlock that keeps its size, ReLU, a global SUM pool and an
  SN dense head to (B, 1) logits.

Every SN convolution has a bias. Inits: xavier-uniform with gain sqrt(2)
on the residual convolutions, gain 1 on the shortcuts, the stem, the RGB
conv and the head, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from ..nn.layers import (
    BatchNorm,
    ConditionalBatchNorm,
    Conv2d,
    Dense,
    SNConv2d,
    SNDense,
    reset_parameters,
    xavier_uniform_,
)
from ..ops.conv import avg_pool2d, upsample_bilinear_torch
from ..utils.policy import resolve_dtype

xavier2 = functools.partial(xavier_uniform_, gain=math.sqrt(2.0))
xavier1 = xavier_uniform_


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    reset_parameters(model, torch.Generator().manual_seed(0) if generator is None else generator)


class GBlock(nn.Module):
    """Residual up-block (B, in, H, W) -> (B, out, 2H, 2W) with ``upsample``,
    else (B, out, H, W). With ``num_classes > 0`` the BNs are
    class-conditional and :meth:`forward` needs labels ``y`` (the JAX
    block takes plain BN when it is called without labels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: Optional[int] = None, upsample: bool = False,
                 num_classes: int = 0):
        super().__init__()
        hidden = hidden_channels or out_channels
        self.upsample, self.num_classes = upsample, num_classes

        def norm(c):
            return ConditionalBatchNorm(c, num_classes) if num_classes > 0 else BatchNorm(c)

        self.b1 = norm(in_channels)
        self.c1 = SNConv2d(in_channels, hidden, 3, padding=1, weight_init=xavier2)
        self.b2 = norm(hidden)
        self.c2 = SNConv2d(hidden, out_channels, 3, padding=1, weight_init=xavier2)
        self.c_sc = (SNConv2d(in_channels, out_channels, 1, weight_init=xavier1)
                     if in_channels != out_channels or upsample else None)

    def _norm(self, bn: nn.Module, x: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        if self.num_classes == 0:
            return bn(x)
        if y is None:
            raise ValueError("a GBlock with class-conditional BN needs labels")
        return bn(x, y.reshape(-1).long())

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self._norm(self.b1, x, y))
        if self.upsample:
            h = upsample_bilinear_torch(h, 2)
        h = self.c1(h)
        h = self.c2(torch.relu(self._norm(self.b2, h, y)))
        sc = x
        if self.c_sc is not None:
            sc = self.c_sc(upsample_bilinear_torch(sc, 2) if self.upsample else sc)
        return h + sc


class DBlock(nn.Module):
    """Residual down-block (B, in, H, W) -> (B, out, H/2, W/2) with
    ``downsample``, else (B, out, H, W)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: Optional[int] = None, downsample: bool = False):
        super().__init__()
        hidden = hidden_channels or in_channels
        self.downsample = downsample
        self.c1 = SNConv2d(in_channels, hidden, 3, padding=1, weight_init=xavier2)
        self.c2 = SNConv2d(hidden, out_channels, 3, padding=1, weight_init=xavier2)
        self.c_sc = (SNConv2d(in_channels, out_channels, 1, weight_init=xavier1)
                     if in_channels != out_channels or downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c2(torch.relu(self.c1(torch.relu(x))))
        if self.downsample:
            h = avg_pool2d(h)
        sc = x
        if self.c_sc is not None:
            sc = self.c_sc(sc)
            if self.downsample:
                sc = avg_pool2d(sc)
        return h + sc


class DBlockOptimized(nn.Module):
    """The discriminator's stem block: conv3x3 -> ReLU -> conv3x3 -> pool,
    plus pool -> 1x1 on the input; halves H and W."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.c1 = SNConv2d(in_channels, out_channels, 3, padding=1, weight_init=xavier2)
        self.c2 = SNConv2d(out_channels, out_channels, 3, padding=1, weight_init=xavier2)
        self.c_sc = SNConv2d(in_channels, out_channels, 1, weight_init=xavier1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = avg_pool2d(self.c2(torch.relu(self.c1(x))))
        return h + self.c_sc(avg_pool2d(x))


class SNGANGenerator(nn.Module):
    """z (B, nz) -> (B, 3, R, R) images in ``compute_dtype``, R =
    bottom_width · 2^num_blocks. 128px: ngf 1024, 5 blocks; 32px: ngf 256,
    3 blocks. With ``num_classes > 0`` the blocks' BNs are class-conditional
    and the forward takes labels ``y``."""

    def __init__(self, nz: int = 128, ngf: int = 1024, bottom_width: int = 4,
                 num_blocks: int = 5, num_classes: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size, self.bottom_width, self.num_blocks = nz, bottom_width, num_blocks
        self.l1 = Dense(nz, bottom_width ** 2 * ngf, weight_init=xavier1)
        cin = ngf
        for i in range(num_blocks):
            # the 128px ladder halves the channels each block after the
            # first (ngf, ngf/2, ..., ngf/16); the 32px one keeps ngf
            cout = ngf >> i if num_blocks == 5 else ngf
            self.add_module(f"block{i + 2}", GBlock(cin, cout, upsample=True,
                                                    num_classes=num_classes))
            cin = cout
        self.b_out = BatchNorm(cin)
        self.c_out = Conv2d(cin, 3, 3, padding=1, bias=True, weight_init=xavier1)
        _init(self, generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, bw = z.shape[0], self.bottom_width
        h = self.l1(z.float()).view(b, bw, bw, -1).permute(0, 3, 1, 2).contiguous()
        h = h.to(resolve_dtype(compute_dtype))
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i + 2}")(h, y)
        return torch.tanh(self.c_out(torch.relu(self.b_out(h))))


class SNGANDiscriminator(nn.Module):
    """(B, in_channels, R, R) images -> (B, 1) logits in ``compute_dtype``.
    ``num_blocks`` 5 (128px: widths ndf/16 ... ndf) or another count (32px:
    ndf throughout), plus the last, size-keeping block."""

    def __init__(self, ndf: int = 1024, num_blocks: int = 5, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_blocks == 5:
            widths = [ndf >> 4, ndf >> 3, ndf >> 2, ndf >> 1, ndf]
        else:
            widths = [ndf] * num_blocks
        self.n_blocks = len(widths) + 1
        self.block1 = DBlockOptimized(in_channels, widths[0])
        for i, w in enumerate(widths[1:], start=2):
            self.add_module(f"block{i}", DBlock(widths[i - 2], w, downsample=True))
        self.add_module(f"block{self.n_blocks}", DBlock(widths[-1], widths[-1]))
        self.l_out = SNDense(widths[-1], 1, weight_init=xavier1)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        h = x.to(resolve_dtype(compute_dtype))
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"block{i}")(h)
        return self.l_out(torch.relu(h).sum(dim=(2, 3)))


def sngan_generator_128(nz: int = 128, ngf: int = 1024, **kw) -> SNGANGenerator:
    return SNGANGenerator(nz=nz, ngf=ngf, bottom_width=4, num_blocks=5, **kw)


def sngan_discriminator_128(ndf: int = 1024, **kw) -> SNGANDiscriminator:
    return SNGANDiscriminator(ndf=ndf, num_blocks=5, **kw)


def sngan_generator_32(nz: int = 128, ngf: int = 256, **kw) -> SNGANGenerator:
    return SNGANGenerator(nz=nz, ngf=ngf, bottom_width=4, num_blocks=3, **kw)


def sngan_discriminator_32(ndf: int = 128, **kw) -> SNGANDiscriminator:
    return SNGANDiscriminator(ndf=ndf, num_blocks=3, **kw)
