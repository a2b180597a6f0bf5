"""SAGAN comparator models, the JAX package's ``models/sagan.py``.

- :class:`SAGANGenerator`: z (as 1x1) -> an SN ConvT stem to 4x4 ->
  ``log2(image_size) - 3`` halving SN ConvT (k4 s2 p1) blocks, each with BN
  and ReLU -> :class:`SelfAttention` (``attn2``) on the ``conv_dim`` map ->
  a biased ConvT to RGB -> tanh.
- :class:`SAGANDiscriminator`: biased SN convolutions (k4 s2 p1) with
  LeakyReLU(0.1), doubling the channels, three layers at 32px and four at
  64px, ``attn1`` after the third, and a 4x4 SN head.

Both return ``(out, attn)``, the attention map (B, N, N) f32, as the JAX
models do; ``zoo.TupleHeadWrapper`` hands the trainer the first. At 64px the
discriminator applies its fourth layer, as the JAX package does (the
reference it follows skips it and cannot run at 64px).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import (
    BatchNorm,
    ConvTranspose2d,
    SelfAttention,
    SNConv2d,
    SNConvTranspose2d,
    reset_parameters,
)
from ..utils.policy import resolve_dtype


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    reset_parameters(model, torch.Generator().manual_seed(0) if generator is None else generator)


class SAGANGenerator(nn.Module):
    """z (B, z_dim) -> ((B, 3, R, R) images in ``compute_dtype``, attn)."""

    def __init__(self, image_size: int = 64, z_dim: int = 100, conv_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size = z_dim
        curr = conv_dim * 2 ** (int(math.log2(image_size)) - 3)
        self.l1_conv = SNConvTranspose2d(z_dim, curr, 4)
        self.l1_bn = BatchNorm(curr)
        self.n_layers = 1
        while curr > conv_dim:
            self.n_layers += 1
            i = self.n_layers
            self.add_module(f"l{i}_conv", SNConvTranspose2d(curr, curr // 2, 4, stride=2,
                                                            padding=1))
            self.add_module(f"l{i}_bn", BatchNorm(curr // 2))
            curr //= 2
        self.attn2 = SelfAttention(curr)
        self.last = ConvTranspose2d(curr, 3, 4, stride=2, padding=1, bias=True)
        _init(self, generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None):
        x = z.to(resolve_dtype(compute_dtype)).view(z.shape[0], -1, 1, 1)
        for i in range(1, self.n_layers + 1):
            x = torch.relu(getattr(self, f"l{i}_bn")(getattr(self, f"l{i}_conv")(x)))
        x, attn = self.attn2(x)
        return torch.tanh(self.last(x)), attn


class SAGANDiscriminator(nn.Module):
    """(B, in_channels, R, R) images -> ((B, 1) logits in ``compute_dtype``,
    attn); R is 32 or 64."""

    def __init__(self, image_size: int = 64, conv_dim: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = 3 if image_size == 32 else 4
        cin, curr = in_channels, conv_dim
        self.l1_conv = SNConv2d(cin, curr, 4, stride=2, padding=1)
        for i in range(2, self.n_layers + 1):
            self.add_module(f"l{i}_conv", SNConv2d(curr, curr * 2, 4, stride=2, padding=1))
            curr *= 2
            if i == 3:
                self.attn1 = SelfAttention(curr)
        self.last = SNConv2d(curr, 1, 4)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32):
        x = x.to(resolve_dtype(compute_dtype))
        for i in range(1, self.n_layers + 1):
            x = F.leaky_relu(getattr(self, f"l{i}_conv")(x), 0.1)
            if i == 3:
                x, attn = self.attn1(x)
        return self.last(x).reshape(x.shape[0], 1), attn
