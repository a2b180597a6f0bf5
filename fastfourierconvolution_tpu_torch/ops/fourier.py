"""Orthonormal real 2-D Fourier transforms of NCHW maps, in factor form.

The transforms run over the (H, W) axes and keep ``Wf = W // 2 + 1``
half-spectrum columns, like ``rfft2``. The factor form writes them as
products with small DFT matrices (W-axis, then H-axis), which is the
definition the FourierUnit kernel computes and the plain version it is
held against.

The inverse is defined as Re(eh · X · fwᵀ), with fw carrying the
half-spectrum duplication weights c (1 at DC and Nyquist, 2 elsewhere).
That definition holds for any input, Hermitian or not. The FourierUnit
feeds the inverse a spectrum that has passed a ReLU, whose DC and
Nyquist columns keep non-zero imaginary parts; ``torch.fft.irfft2``
agrees with the definition on the CPU (pocketfft), but cuFFT's
multi-dimensional C2R makes no promise for non-Hermitian input. The
``*_fft`` forms are therefore used only in tests and as information.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .cache import tensor_cache


@functools.lru_cache(maxsize=64)
def forward_factors(h: int, w: int) -> Tuple[np.ndarray, ...]:
    """Real/imag parts of the orthonormal forward rDFT factor matrices.

    Returns (ah, bh, cw, dw):
      ah[u,p], bh[u,p]: re/im of exp(-2i*pi*u*p/H) / sqrt(H*W)  (H x H)
      cw[q,v], dw[q,v]: re/im of exp(-2i*pi*v*q/W) for v < Wf   (W x Wf)
    """
    wf = w // 2 + 1
    u = np.arange(h)[:, None]
    p = np.arange(h)[None, :]
    ang_h = -2.0 * np.pi * (u * p % h) / h
    scale = 1.0 / np.sqrt(h * w)
    ah = (np.cos(ang_h) * scale).astype(np.float32)
    bh = (np.sin(ang_h) * scale).astype(np.float32)
    q = np.arange(w)[:, None]
    v = np.arange(wf)[None, :]
    ang_w = -2.0 * np.pi * (q * v % w) / w
    cw = np.cos(ang_w).astype(np.float32)
    dw = np.sin(ang_w).astype(np.float32)
    return ah, bh, cw, dw


@functools.lru_cache(maxsize=64)
def inverse_factors(h: int, w: int) -> Tuple[np.ndarray, ...]:
    """Real/imag parts of the orthonormal inverse rDFT factor matrices.

    Returns (eh_r, eh_i, fw_r, fw_i):
      eh[p,u] = exp(+2i*pi*u*p/H) / sqrt(H*W)       (H x H)
      fw[q,v] = c[v] * exp(+2i*pi*v*q/W)            (W x Wf)
    """
    wf = w // 2 + 1
    p = np.arange(h)[:, None]
    u = np.arange(h)[None, :]
    ang_h = 2.0 * np.pi * (u * p % h) / h
    scale = 1.0 / np.sqrt(h * w)
    eh_r = (np.cos(ang_h) * scale).astype(np.float32)
    eh_i = (np.sin(ang_h) * scale).astype(np.float32)
    c = np.full((wf,), 2.0)  # half-spectrum duplication weights
    c[0] = 1.0
    if w % 2 == 0:
        c[-1] = 1.0
    q = np.arange(w)[:, None]
    v = np.arange(wf)[None, :]
    ang_w = 2.0 * np.pi * (q * v % w) / w
    fw_r = (np.cos(ang_w) * c[None, :]).astype(np.float32)
    fw_i = (np.sin(ang_w) * c[None, :]).astype(np.float32)
    return eh_r, eh_i, fw_r, fw_i


@tensor_cache
def _factor_tensors(h: int, w: int, dtype: torch.dtype, device: torch.device):
    mats = forward_factors(h, w) + inverse_factors(h, w)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dtype) for m in mats)


def factors(h: int, w: int, dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """(ah, bh, cw, dw, eh_r, eh_i, fw_r, fw_i) as tensors of ``dtype`` on
    ``device``; cached outside tracing (``cache.tensor_cache``), so treat
    them as read-only."""
    return _factor_tensors(h, w, dtype, torch.device(device))


def rfft2_ortho(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward rDFT of (B, C, H, W) in factor form, computed in x's dtype.

    Returns (real, imag), each (B, C, H, Wf).
    """
    h, w = x.shape[-2], x.shape[-1]
    ah, bh, cw, dw = factors(h, w, x.dtype, x.device)[:4]
    t_r = x @ cw
    t_i = x @ dw
    f_r = ah @ t_r - bh @ t_i
    f_i = ah @ t_i + bh @ t_r
    return f_r, f_i


def irfft2_ortho(
    f_r: torch.Tensor, f_i: torch.Tensor, s: Tuple[int, int]
) -> torch.Tensor:
    """Inverse of :func:`rfft2_ortho`: Re(eh · F · fwᵀ), (B, C, H, W)."""
    h, w = s
    eh_r, eh_i, fw_r, fw_i = factors(h, w, f_r.dtype, f_r.device)[4:]
    p_r = eh_r @ f_r - eh_i @ f_i
    p_i = eh_r @ f_i + eh_i @ f_r
    return p_r @ fw_r.T - p_i @ fw_i.T


def irfft2_ortho_adjoint(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjoint of :func:`irfft2_ortho` as a real-linear map, in g's dtype:
    (B, C, H, W) -> (real, imag), each (B, C, H, Wf)."""
    h, w = g.shape[-2], g.shape[-1]
    eh_r, eh_i, fw_r, fw_i = factors(h, w, g.dtype, g.device)[4:]
    gp_r = g @ fw_r
    gp_i = -(g @ fw_i)
    gf_r = eh_r.T @ gp_r + eh_i.T @ gp_i
    gf_i = -(eh_i.T @ gp_r) + eh_r.T @ gp_i
    return gf_r, gf_i


def rfft2_ortho_adjoint(
    g_r: torch.Tensor, g_i: torch.Tensor, s: Tuple[int, int]
) -> torch.Tensor:
    """Adjoint of :func:`rfft2_ortho`, in the operands' dtype: two
    (B, C, H, Wf) -> (B, C, H, W)."""
    h, w = s
    ah, bh, cw, dw = factors(h, w, g_r.dtype, g_r.device)[:4]
    gt_r = ah.T @ g_r + bh.T @ g_i
    gt_i = -(bh.T @ g_r) + ah.T @ g_i
    return gt_r @ cw.T + gt_i @ dw.T


def rfft2_ortho_fft(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.fft`` form of :func:`rfft2_ortho`, in f32."""
    f = torch.fft.rfft2(x.float(), norm="ortho")
    return f.real, f.imag


def irfft2_ortho_fft(
    f_r: torch.Tensor, f_i: torch.Tensor, s: Tuple[int, int]
) -> torch.Tensor:
    """``torch.fft`` form of :func:`irfft2_ortho`, in f32."""
    f = torch.complex(f_r.float(), f_i.float())
    return torch.fft.irfft2(f, s=s, norm="ortho")
