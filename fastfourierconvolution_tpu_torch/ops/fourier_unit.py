"""FourierUnit eval forward: rfft2 -> (2C, 2C) mix -> BN -> ReLU -> irfft2.

``fourier_unit_forward_plain`` is the plain PyTorch version: the eval
math of the JAX package's ``_spec_forward`` with its cast points (the
transforms and the mix run in x's dtype, BN in f32, the post-ReLU
spectrum is cast back to x's dtype before the inverse).

``fourier_unit_forward`` is the op the model calls. For a CPU tensor it
runs the plain version; for a CUDA tensor it launches the hand-written
kernel ``csrc/fourier_unit_fwd.cu`` or raises. Its ``launches`` attribute
counts kernel launches, and ``launches_by_map`` counts them by (C, H, W).

Layout: x is (B, C, H, W); kernel (2C, 2C) in x's dtype, [re; im] on
both axes; scale, bias, mean and var are (2C,) f32 (BN running stats in
eval). Training adds batch statistics computed by a stats kernel and
passes them in the mean/var slots.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from .fourier import irfft2_ortho, rfft2_ortho

EPS = 1e-5

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fourier_unit_forward_plain(x, kernel, scale, bias, mean, var):
    """Plain PyTorch FourierUnit eval forward; returns y like x."""
    c = x.shape[1]
    h, w = x.shape[2], x.shape[3]
    dt = x.dtype
    f_r, f_i = rfft2_ortho(x)
    z = torch.cat([f_r, f_i], dim=1)  # (B, 2C, H, Wf)
    m = torch.einsum("bjuv,jd->bduv", z, kernel)
    mf = m.float()
    col = lambda t: t.float()[:, None, None]
    pre = (mf - col(mean)) * torch.rsqrt(col(var) + EPS) * col(scale) + col(bias)
    r = torch.relu(pre).to(dt)
    return irfft2_ortho(r[:, :c], r[:, c:], (h, w))


def _check_args(x, kernel, scale, bias, mean, var):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c2 = 2 * x.shape[1]
    if kernel.shape != (c2, c2) or kernel.dtype != x.dtype:
        raise ValueError(
            f"kernel must be ({c2}, {c2}) {x.dtype}, got "
            f"{tuple(kernel.shape)} {kernel.dtype}"
        )
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        if t.shape != (c2,) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be ({c2},) float32, got {tuple(t.shape)} {t.dtype}"
            )
    if any(t.device != x.device for t in (kernel, scale, bias, mean, var)):
        raise ValueError("all FourierUnit operands must be on one device")


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = _build.library("fourier_unit_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ffc_fourier_unit_fwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.ffc_fourier_unit_fwd.restype = i
    lib.ffc_fourier_unit_fwd_smem_bytes.argtypes = [i, i, i]
    lib.ffc_fourier_unit_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.ffc_fourier_unit_fwd_allow_smem.argtypes = [i, i]
    lib.ffc_fourier_unit_fwd_allow_smem.restype = i
    lib.ffc_cuda_error_string.argtypes = [i]
    lib.ffc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"FourierUnit kernel {what} failed: "
            + _kernel_library().ffc_cuda_error_string(err).decode()
        )


@functools.cache
def _smem_limit(device_index: int, dtype_code: int) -> int:
    """The card's shared memory per block, which the dtype's kernel is
    allowed to take on this device (set once per device and dtype)."""
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    with torch.cuda.device(device_index):
        _raise_on(
            _kernel_library().ffc_fourier_unit_fwd_allow_smem(dtype_code, limit),
            "set-up",
        )
    return limit


@functools.cache
def _smem_bytes(c: int, h: int, w: int) -> int:
    return _kernel_library().ffc_fourier_unit_fwd_smem_bytes(c, h, w)


def _launch_kernel(x, kernel, scale, bias, mean, var):
    if not all(t.is_contiguous() for t in (x, kernel, scale, bias, mean, var)):
        raise ValueError("the FourierUnit kernel takes contiguous tensors")
    b, c, h, w = x.shape
    code = _DTYPE_CODES[x.dtype]
    smem = _smem_bytes(c, h, w)
    limit = _smem_limit(x.device.index, code)
    if smem > limit:
        raise ValueError(
            f"a ({c}, {h}, {w}) item needs {smem} bytes of shared memory; "
            f"the card gives a block at most {limit}"
        )
    y = torch.empty_like(x)
    if b == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_library().ffc_fourier_unit_fwd(
            code, x.data_ptr(), kernel.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
            y.data_ptr(), b, c, h, w, stream,
        )
    _raise_on(err, "launch")
    fourier_unit_forward.launches += 1
    fourier_unit_forward.launches_by_map[(c, h, w)] += 1
    return y


def fourier_unit_forward(x, kernel, scale, bias, mean, var):
    """FourierUnit eval forward; the kernel on CUDA, the plain version on
    the CPU. Returns y with x's shape and dtype."""
    _check_args(x, kernel, scale, bias, mean, var)
    if x.device.type == "cpu":
        return fourier_unit_forward_plain(x, kernel, scale, bias, mean, var)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_kernel(x, kernel, scale, bias, mean, var)


fourier_unit_forward.launches = 0
fourier_unit_forward.launches_by_map = collections.Counter()  # by (C, H, W)
