"""Convolution, resampling and pooling ops on NCHW activations.

Weights are torch's layouts (OIHW for a convolution, IOHW for a
transposed one) and stay f32; each op casts them to the activation's
dtype, as the JAX package casts its operands to the compute dtype. The
geometry is torch's:

  conv:   out = floor((in + 2p - d*(k-1) - 1)/s) + 1
  convT:  out = (in-1)*s - 2p + d*(k-1) + output_padding + 1
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, weight, *, stride=1, padding=0) -> torch.Tensor:
    """2-D convolution, (B, Ci, H, W) x OIHW -> (B, Co, H', W')."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding)


def conv_transpose2d(
    x, weight, *, stride=1, padding=0, output_padding=0
) -> torch.Tensor:
    """2-D transposed convolution, (B, Ci, H, W) x IOHW -> (B, Co, H', W')."""
    return F.conv_transpose2d(
        x, weight.to(x.dtype), stride=stride, padding=padding,
        output_padding=output_padding,
    )


def avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C) mean over the spatial axes."""
    return x.mean(dim=(2, 3))
