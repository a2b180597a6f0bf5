"""Plain-conv DCGAN models, the JAX package's ``models/dcgan.py``.

Generators take ``(z, compute_dtype, generator=None)`` and draw no noise;
discriminators take ``(x, compute_dtype)`` on NCHW images and return (B, 1)
sigmoid probabilities.

- :class:`DCGANGenerator`: z (as 1x1) -> four bias-free ConvT + BN + ReLU
  steps (4x4 stem, then k4 s2 p1) -> a bias-free ConvT to ``nc`` -> tanh;
  64 x 64 images.
- :class:`DCGANDiscriminator`: four bias-free k4 s2 p1 convolutions (BN
  from the second on) with LeakyReLU(0.2), a bias-free 4x4 head and
  sigmoid; 64 x 64 images.
- :class:`SNDCGANDiscriminator`: the same ladder with biased spectral-normed
  convolutions and no BN.
- :class:`AttnConvGenerator`: a dense stem (f32, as flax's Dense promotes
  to its parameters), three ConvT + BN + ReLU blocks, :class:`SelfAttention`,
  a 3x3 ConvT to RGB and tanh; ``mg * 8`` px.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
    SelfAttention,
    SNConv2d,
    reset_parameters,
)
from ..utils.policy import resolve_dtype


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    reset_parameters(model, torch.Generator().manual_seed(0) if generator is None else generator)


class DCGANGenerator(nn.Module):
    """z (B, nz) -> (B, nc, 64, 64) images in ``compute_dtype``."""

    def __init__(self, nz: int = 100, nc: int = 3, ngf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size = nz
        cin = nz
        for i, mult in enumerate((8, 4, 2, 1)):
            stride, pad = (1, 0) if i == 0 else (2, 1)
            self.add_module(f"convt{i}", ConvTranspose2d(cin, ngf * mult, 4, stride=stride,
                                                         padding=pad))
            self.add_module(f"bn{i}", BatchNorm(ngf * mult))
            cin = ngf * mult
        self.to_rgb = ConvTranspose2d(cin, nc, 4, stride=2, padding=1)
        _init(self, generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = z.to(resolve_dtype(compute_dtype)).view(z.shape[0], -1, 1, 1)
        for i in range(4):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"convt{i}")(x)))
        return torch.tanh(self.to_rgb(x))


class DCGANDiscriminator(nn.Module):
    """(B, nc, 64, 64) images -> (B, 1) probabilities in ``compute_dtype``."""

    def __init__(self, nc: int = 3, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = nc
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", Conv2d(cin, ndf * mult, 4, stride=2, padding=1))
            if i > 0:
                self.add_module(f"bn{i}", BatchNorm(ndf * mult))
            cin = ndf * mult
        self.head = Conv2d(cin, 1, 4)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        x = x.to(resolve_dtype(compute_dtype))
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
            if i > 0:
                x = getattr(self, f"bn{i}")(x)
            x = F.leaky_relu(x, 0.2)
        return torch.sigmoid(self.head(x).reshape(x.shape[0], 1))


class SNDCGANDiscriminator(nn.Module):
    """:class:`DCGANDiscriminator` with biased spectral-normed convolutions
    and no BN."""

    def __init__(self, nc: int = 3, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = nc
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", SNConv2d(cin, ndf * mult, 4, stride=2, padding=1))
            cin = ndf * mult
        self.head = SNConv2d(cin, 1, 4)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        x = x.to(resolve_dtype(compute_dtype))
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
        return torch.sigmoid(self.head(x).reshape(x.shape[0], 1))


class AttnConvGenerator(nn.Module):
    """z (B, z_size) -> (B, 3, 8·mg, 8·mg) images in ``compute_dtype``: a
    dense stem to (mg, mg, 8·ngf) laid out NHWC as in the JAX package,
    three ConvT (k4 s2 p1, bias-free) + BN + ReLU blocks to ngf channels,
    self-attention over the 8·mg x 8·mg map, a 3x3 ConvT to RGB, tanh."""

    def __init__(self, z_size: int = 128, mg: int = 4, ngf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size, self.mg = z_size, mg
        self.noise_to_feature = Dense(z_size, mg * mg * ngf * 8)
        cin = ngf * 8
        for i, mult in enumerate((4, 2, 1)):
            self.add_module(f"convt{i}", ConvTranspose2d(cin, ngf * mult, 4, stride=2, padding=1))
            self.add_module(f"bn{i}", BatchNorm(ngf * mult))
            cin = ngf * mult
        self.attn = SelfAttention(cin)
        self.to_rgb = ConvTranspose2d(cin, 3, 3, padding=1)
        _init(self, generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = z.shape[0]
        stem = self.noise_to_feature(z.float())
        x = stem.view(b, self.mg, self.mg, -1).permute(0, 3, 1, 2).contiguous()
        x = x.to(resolve_dtype(compute_dtype))
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"convt{i}")(x)))
        x, _ = self.attn(x)
        return torch.tanh(self.to_rgb(x))
