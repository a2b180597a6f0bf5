"""TF1-exact bilinear resize, the JAX package's ``eval/resize.py``.

TensorFlow 1.x ``resize_bilinear`` semantics, which torch-fidelity
reproduces for its InceptionV3 (interpolate_compat_tensorflow.py):

  align_corners=False:  scale = in/out,        src = out_idx * scale
  align_corners=True:   scale = (in-1)/(out-1), src = out_idx * scale
  lo = floor(src); hi = min(lo+1, in-1); lerp by (src - lo)

The resize is separable and linear, so it is two products with (out, in)
weight matrices, each row holding the two lerp weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) row-stochastic lerp weights for one axis."""
    if align_corners:
        scale = (in_size - 1) / max(1, out_size - 1)
    else:
        scale = in_size / out_size
    idx = np.arange(out_size, dtype=np.float64)
    # TF computes the source positions on float32 grids; match that rounding.
    src = (idx * np.float32(scale)).astype(np.float32)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    w[np.arange(out_size), lo] += 1.0 - frac
    w[np.arange(out_size), hi] += frac
    return w.astype(np.float32)


def resize_bilinear_tf1(x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False,
                        layout: str = "NHWC") -> torch.Tensor:
    """Resize ``x`` (``layout`` "NHWC" or "NCHW") to spatial ``size`` with TF1
    bilinear semantics. A float input keeps its dtype (a float64 input
    resizes in float64); anything else (uint8) computes in float32."""
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be 'NHWC' or 'NCHW', got {layout!r}")
    dtype = x.dtype if x.is_floating_point() else torch.float32
    h_axis = 1 if layout == "NHWC" else 2
    in_h, in_w = x.shape[h_axis], x.shape[h_axis + 1]
    wh = torch.from_numpy(_resize_matrix(in_h, size[0], align_corners)).to(x.device, dtype)
    ww = torch.from_numpy(_resize_matrix(in_w, size[1], align_corners)).to(x.device, dtype)
    x = x.to(dtype)
    if layout == "NCHW":
        return torch.matmul(torch.matmul(wh, x), ww.T)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bhwc->bhpc", ww, x)
