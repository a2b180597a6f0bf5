"""Convolution, resampling and pooling ops on NCHW activations.

Weights are torch's layouts (OIHW for a convolution, IOHW for a
transposed one) and stay f32; each op casts them to the activation's
dtype, as the JAX package casts its operands to the compute dtype. The
geometry is torch's:

  conv:   out = floor((in + 2p - d*(k-1) - 1)/s) + 1
  convT:  out = (in-1)*s - 2p + d*(k-1) + output_padding + 1
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cache import tensor_cache


def conv2d(x, weight, *, stride=1, padding=0, dilation=1, groups=1) -> torch.Tensor:
    """2-D convolution, (B, Ci, H, W) x OIHW -> (B, Co, H', W'); with
    ``groups`` the weight is (Co, Ci / groups, k, k)."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose2d(
    x, weight, *, stride=1, padding=0, output_padding=0, dilation=1, groups=1
) -> torch.Tensor:
    """2-D transposed convolution, (B, Ci, H, W) x IOHW -> (B, Co, H', W');
    with ``groups`` the weight is (Ci, Co / groups, k, k)."""
    return F.conv_transpose2d(
        x, weight.to(x.dtype), stride=stride, padding=padding,
        output_padding=output_padding, groups=groups, dilation=dilation,
    )


def avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@tensor_cache
def bilinear_up_matrix(n: int, scale: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """(scale * n, n) weights of a bilinear upsample along one axis with
    half-pixel centres (``align_corners=False``), on ``device`` in
    ``dtype``. Cached outside tracing (``cache.tensor_cache``): a captured
    CUDA graph reads the tensor the eager step before the capture built,
    and nothing writes to it."""
    out = scale * n
    src = (np.arange(out, dtype=np.float64) + 0.5) / scale - 0.5
    lo = np.clip(np.floor(src), 0, n - 1).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    frac = np.clip(src - lo, 0.0, 1.0)
    w = np.zeros((out, n), dtype=np.float64)
    w[np.arange(out), lo] += 1.0 - frac
    w[np.arange(out), hi] += frac
    return torch.from_numpy(w.astype(np.float32)).to(device=device, dtype=dtype)


def upsample_bilinear_torch(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear upsample of (B, C, H, W) by ``scale`` with
    ``F.interpolate(mode="bilinear", align_corners=False)`` semantics, as
    two separable products with the weights of :func:`bilinear_up_matrix`
    (as the JAX package computes it). Unlike ``upsample_bilinear2d`` on
    CUDA, its backward is deterministic."""
    h, w = x.shape[-2:]
    wh = bilinear_up_matrix(h, scale, x.device, x.dtype)
    ww = bilinear_up_matrix(w, scale, x.device, x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.T)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C) mean over the spatial axes."""
    return x.mean(dim=(2, 3))
