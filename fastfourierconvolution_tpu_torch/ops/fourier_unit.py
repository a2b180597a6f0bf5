"""FourierUnit: rfft2 -> (2C, 2C) mix -> BN -> ReLU -> irfft2, eval and train.

Plain PyTorch versions, the math of the JAX package's ``_spec_forward`` and
``_jnp_backward`` with their cast points (the transforms and the mix run in
x's dtype, BN and its statistics in f32, the post-ReLU spectrum and the
BN cotangent gm are cast back to x's dtype). Given float64 operands they
compute in float64 throughout, which is how the kernels' reference is
taken on the card:

- ``fourier_unit_forward_plain``: forward with the statistics it is given;
- ``fu_train_stats_plain``: batch mean and biased variance of m over
  (B, H, Wf), f32;
- ``fourier_unit_train_plain``: train forward, ``(y, bmean, bvar)``;
- ``fu_bwd_stats_plain``, ``fu_bwd_apply_plain`` and their composition
  ``fourier_unit_backward_plain``: the rematerialising backward;
- ``fu_spectrum_plain``, ``fu_mix_apply_plain``, ``fu_mix_stats_plain``,
  ``fu_bwd_stats_mix_plain``, ``fu_inverse_plain`` and
  ``fu_bwd_mix_plain``: the stages of the staged design below, in f32
  (f64 for f64 operands) whatever x's dtype, as the kernels compute.

Kernel wrappers. For a CPU tensor each runs its plain version; for a CUDA
tensor it launches its hand-written kernel or raises. Each counts the
launches of its own kernel in ``launches`` and, by FourierUnit map
(C, H, W), in ``launches_by_map`` (``fu_reduce`` by partial-sum shape
(rows, cols)):

- ``fourier_unit_forward``: the per-item kernels of
  ``csrc/fourier_unit_fwd.cu``;
- ``fu_train_stats``, ``fu_bwd_stats``, ``fu_bwd_apply`` and ``fu_reduce``
  (the fixed-order batch sum behind the first three and behind the
  staged mix stages that write partial sums; those callers go through
  ``_reduce``, which skips the public checks; :func:`reduce_design` picks
  its tiles and clusters):
  ``csrc/fourier_unit_train.cu``;
- ``fu_spectrum``, ``fu_mix_apply``, ``fu_mix_stats``,
  ``fu_bwd_stats_mix``, ``fu_inverse`` and ``fu_bwd_mix``:
  ``csrc/fourier_unit_staged.cu``.

Maps of any size. :func:`kernel_design` picks, by a fixed rule on the map
and the card's shared memory per block, how ``fourier_unit_forward``,
``fu_bwd_apply`` and the statistics (``fu_train_stats``, ``fu_bwd_stats``)
run a map: their per-item kernel with the item in shared memory; else the
staged kernels, which work per (item, channel) plane and per tile of
spectral positions (the wrapper then launches those and not its own
kernel); else their per-item kernel with the item in shared memory where
it fits once spread over a cluster's ranks; else their per-item kernel
with the item in an f32 device workspace. In shared memory every per-item
wrapper (the forward, the statistics, the backward sums and the backward
apply) runs its clustered kernel (``csrc/fourier_unit_item.cuh``): each
item on a thread-block cluster of :func:`item_design` ranks, each rank on
its share of the channels, with DFT tables built once per (H, W) and
device (``_item_tables``).

``fourier_unit_train`` is the training op the model calls: an autograd
Function. Where the statistics run per item, its forward runs the stats
kernel and then the forward kernel with the batch statistics in the
mean/var slots, and its backward runs the two backward kernels. Where they
run staged, its forward and its backward each compute the spectra once and
feed them to the statistics stage and then to the apply stage
(``_train_forward_staged``, ``_train_backward_staged``). It saves only (x,
kernel, scale, bias, bmean, bvar) and returns bmean/bvar as
non-differentiable outputs. ``fourier_unit_eval`` is the eval op, an
autograd Function over ``fourier_unit_forward`` whose backward runs the
same backward kernels with the running statistics. Both backwards are
themselves an autograd Function (``_FourierUnitBackward``), so the op has
a double backward: the VJP of the plain backward, as the JAX package
differentiates its jnp backward (a gradient penalty takes it).

Layout: x, y, gy and gx are (B, C, H, W); kernel (2C, 2C) in x's dtype,
[re; im] on both axes; scale, bias and the statistics are (2C,) f32.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from . import _build
from .fourier import (
    forward_factors,
    irfft2_ortho,
    irfft2_ortho_adjoint,
    rfft2_ortho,
    rfft2_ortho_adjoint,
)

EPS = 1e-5

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --- plain PyTorch versions ---------------------------------------------------


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in float64 when it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _col(t: torch.Tensor) -> torch.Tensor:
    return _f32(t)[:, None, None]


def _spectrum_plain(x, kernel):
    """z = [re; im] rfft2(x), (B, 2C, H, Wf), and m = z mixed by kernel,
    both in x's dtype."""
    f_r, f_i = rfft2_ortho(x)
    z = torch.cat([f_r, f_i], dim=1)
    return z, torch.einsum("bjuv,jd->bduv", z, kernel)


def fourier_unit_forward_plain(x, kernel, scale, bias, mean, var):
    """Plain PyTorch FourierUnit forward with the given statistics; returns
    y like x."""
    c = x.shape[1]
    h, w = x.shape[2], x.shape[3]
    _, m = _spectrum_plain(x, kernel)
    pre = (_f32(m) - _col(mean)) * torch.rsqrt(_col(var) + EPS) * _col(scale) + _col(bias)
    r = torch.relu(pre).to(x.dtype)
    return irfft2_ortho(r[:, :c], r[:, c:], (h, w))


def fu_train_stats_plain(x, kernel):
    """(bmean, bvar): f32 mean and biased variance E[m²] − E[m]² of each
    of the 2C channels of m over (B, H, Wf)."""
    _, m = _spectrum_plain(x, kernel)
    mf = _f32(m)
    bmean = mf.mean(dim=(0, 2, 3))
    return bmean, (mf * mf).mean(dim=(0, 2, 3)) - bmean * bmean


def fourier_unit_train_plain(x, kernel, scale, bias):
    """Plain train forward: ``(y, bmean, bvar)``, y normalised with the
    batch statistics."""
    bmean, bvar = fu_train_stats_plain(x, kernel)
    return fourier_unit_forward_plain(x, kernel, scale, bias, bmean, bvar), bmean, bvar


def _bwd_recompute_plain(x, kernel, scale, bias, bmean, bvar, gy):
    """Recompute z (x's dtype), n̂, inv and gpre (f32) from x and gy."""
    z, m = _spectrum_plain(x, kernel)
    inv = torch.rsqrt(bvar + EPS)
    n_hat = (_f32(m) - _col(bmean)) * _col(inv)
    pre = n_hat * _col(scale) + _col(bias)
    gr_r, gr_i = irfft2_ortho_adjoint(gy)
    gpre = _f32(torch.cat([gr_r, gr_i], dim=1)) * (pre > 0)
    return z, n_hat, inv, gpre


def fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy):
    """(gscale, gbias) = (Σ gpre·n̂, Σ gpre) over (B, H, Wf), f32."""
    _, n_hat, _, gpre = _bwd_recompute_plain(x, kernel, scale, bias, bmean, bvar, gy)
    return (gpre * n_hat).sum(dim=(0, 2, 3)), gpre.sum(dim=(0, 2, 3))


def _coupled_bn_cotangent(gn, n_hat, inv, scale, gscale, gbias):
    """gm = inv·(gn − mean(gn) − n̂·mean(gn·n̂)) over (B, H, Wf), with
    Σgn = scale·gbias and Σgn·n̂ = scale·gscale."""
    n = gn.shape[0] * gn.shape[2] * gn.shape[3]
    return _col(inv) * (gn - _col(scale * gbias / n) - n_hat * _col(scale * gscale / n))


def fu_bwd_apply_plain(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias, train=True):
    """(gx like x, gK (2C, 2C) f32). In train mode gm is the coupled-BN
    cotangent (``_coupled_bn_cotangent``); in eval gm = gn·inv."""
    c, h, w = x.shape[1:]
    z, n_hat, inv, gpre = _bwd_recompute_plain(x, kernel, scale, bias, bmean, bvar, gy)
    gn = gpre * _col(scale)
    if train:
        gm = _coupled_bn_cotangent(gn, n_hat, inv, scale, gscale, gbias)
    else:
        gm = gn * _col(inv)
    gm = gm.to(x.dtype)
    gk = torch.einsum("bjuv,bduv->jd", _f32(z), _f32(gm))
    gz = torch.einsum("bduv,jd->bjuv", gm, kernel)
    return rfft2_ortho_adjoint(gz[:, :c], gz[:, c:], (h, w)), gk


def fourier_unit_backward_plain(x, kernel, scale, bias, bmean, bvar, gy, train=True):
    """The backward of the JAX package's ``_jnp_backward``: (gx, gK in
    kernel's dtype, gscale, gbias, zeros, zeros); the statistics get zero
    gradients."""
    gscale, gbias = fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)
    gx, gk = fu_bwd_apply_plain(
        x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias, train
    )
    zeros = torch.zeros_like(bmean)
    return gx, gk.to(kernel.dtype), gscale, gbias, zeros, zeros


# The stages of the staged design. Spectra are (B, 2C, H, Wf) [re; im] with
# Wf = W/2 + 1 of an even W; every stage computes in f32, or in f64 for f64
# operands.


def _half_weights(spec):
    """c (Wf,) in spec's dtype: 1 at DC and Nyquist, 2 elsewhere (W even)."""
    c = torch.full((spec.shape[3],), 2.0, dtype=spec.dtype, device=spec.device)
    c[0] = c[-1] = 1.0
    return c


def fu_spectrum_plain(*maps):
    """[re; im] rfft2 of each (B, C, H, W) map, stacked:
    (len(maps), B, 2C, H, Wf)."""
    return torch.stack([torch.cat(rfft2_ortho(_f32(m)), dim=1) for m in maps])


def _stage_mix(z, kernel):
    """m = z mixed by kernel, like z."""
    return torch.einsum("bjuv,jd->bduv", z, kernel.to(z.dtype))


def _stage_bn(z, kernel, scale, bias, mean, var):
    """(n̂, inv, pre) of m = z mixed by kernel, BN with the given
    statistics."""
    inv = torch.rsqrt(var + EPS)
    n_hat = (_stage_mix(z, kernel) - _col(mean)) * _col(inv)
    return n_hat, inv, n_hat * _col(scale) + _col(bias)


def fu_mix_apply_plain(z, kernel, scale, bias, mean, var):
    """r = c·ReLU(BN(z mixed by kernel)) with the given statistics, like z."""
    return torch.relu(_stage_bn(z, kernel, scale, bias, mean, var)[2]) * _half_weights(z)


def fu_mix_stats_plain(z, kernel):
    """(bmean, bvar): mean and biased variance E[m²] − E[m]² of each of the
    2C channels of m = z mixed by kernel over (B, H, Wf), no half-spectrum
    weights (as ``fu_train_stats_plain``), like z."""
    m = _stage_mix(z, kernel)
    bmean = m.mean(dim=(0, 2, 3))
    return bmean, (m * m).mean(dim=(0, 2, 3)) - bmean * bmean


def fu_bwd_stats_mix_plain(z, g, kernel, scale, bias, bmean, bvar):
    """(gscale, gbias) = (Σ gpre·n̂, Σ gpre) over (B, H, Wf) from z and G =
    DFT(gy), gpre = c·G·[pre > 0] (as ``fu_bwd_stats_plain``), like z."""
    n_hat, _, pre = _stage_bn(z, kernel, scale, bias, bmean, bvar)
    gpre = g * _half_weights(z) * (pre > 0)
    return (gpre * n_hat).sum(dim=(0, 2, 3)), gpre.sum(dim=(0, 2, 3))


def fu_inverse_plain(spec, dtype, w):
    """Re(eh · R · fwᵀ) without half-spectrum weights, the adjoint of the
    forward rDFT: (B, C, H, W) in ``dtype``."""
    c = spec.shape[1] // 2
    return rfft2_ortho_adjoint(spec[:, :c], spec[:, c:], (spec.shape[2], w)).to(dtype)


def fu_bwd_mix_plain(z, g, kernel, scale, bias, bmean, bvar, gscale, gbias):
    """The backward apply's mix stage from z and G = DFT(gy): (gz, gK)
    with gm the coupled-BN cotangent of gpre = c·G·[pre > 0]."""
    n_hat, inv, pre = _stage_bn(z, kernel, scale, bias, bmean, bvar)
    gn = g * _half_weights(z) * (pre > 0) * _col(scale)
    gm = _coupled_bn_cotangent(gn, n_hat, inv, scale, gscale, gbias)
    gz = torch.einsum("bduv,jd->bjuv", gm, kernel.to(z.dtype))
    return gz, torch.einsum("bjuv,bduv->jd", z, gm)


def fu_reduce_plain(partial, count=0):
    """Sum of the rows of ``partial`` (rows, cols) f32; with ``count`` > 0
    and rows of [sums | sums of squares], [mean | E[m²] − mean²]."""
    sums = partial.sum(dim=0)
    if count == 0:
        return sums
    s1, s2 = sums.chunk(2)
    mean = s1 / count
    return torch.cat([mean, s2 / count - mean * mean])


def relu_margin_bias(x, kernel, scale, bias, mean, var):
    """``bias`` moved so that no pre-activation of the ReLU lies near 0 on
    these inputs: per channel, the values of pre within 0.05 of 0 are
    sorted (in f64) and 0 goes to the middle of the widest gap between
    neighbours. The backward's outputs jump where an element crosses 0, so
    a kernel that computes pre in f32 and its plain version in f64 take the
    same ReLU mask only away from 0; with these biases the two can be held
    to each other at the kernel's own rounding. Returns (bias (2C,) f32,
    the least distance from 0 of any pre-activation)."""
    _, m = _spectrum_plain(x.double(), kernel.double())
    isc = torch.rsqrt(var.double() + EPS) * scale.double()
    pre = (m - _col(mean.double())) * _col(isc) + _col(bias.double())
    pre = pre.transpose(0, 1).reshape(2 * x.shape[1], -1).sort(dim=1).values
    mids = (pre[:, 1:] + pre[:, :-1]) / 2
    gaps = torch.where(mids.abs() < 0.05, pre[:, 1:] - pre[:, :-1], 0.0)
    best = gaps.argmax(dim=1, keepdim=True)
    shift = mids.gather(1, best)[:, 0]
    return (bias.double() - shift).float(), gaps.gather(1, best).min().item() / 2


# --- argument checks ------------------------------------------------------------


def _check_args(x, kernel, **vectors):
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
    for name, t in vectors.items():
        if name == "gy":
            if t.shape != x.shape or t.dtype != x.dtype:
                raise ValueError(
                    f"gy must be {tuple(x.shape)} {x.dtype}, got {tuple(t.shape)} {t.dtype}"
                )
        elif t.shape != (c2,) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be ({c2},) float32, got {tuple(t.shape)} {t.dtype}"
            )
    if any(t.device != x.device for t in (kernel, *vectors.values())):
        raise ValueError("all FourierUnit operands must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


# --- the CUDA libraries ---------------------------------------------------------
#
# Each library exports ffc_allow_smem(dtype, bytes) and ffc_error_string(code)
# beside its entry points, which return a cudaError_t; the per-item
# libraries also ffc_item_floats(C, H, W), the workspace kernels' plan that
# _item_floats mirrors, and ffc_item_rank_floats(C, H, W, R) (the training
# library also ffc_item_train_stats_rank_floats and
# ffc_item_bwd_stats_rank_floats), the plan of one rank of a clustered
# kernel that _item_rank_floats mirrors. Each per-item wrapper runs its
# clustered kernel (csrc/fourier_unit_item.cuh) where the map is SHARED,
# whether the one-block plan or only the per-rank plans fit, and its
# workspace kernel, which keeps the item's buffers in its slice of an f32
# device workspace (csrc/fourier_unit_common.cuh), where it is WORKSPACE:
# the staged kernels do not take the map and no per-rank plan fits (the
# 96px generator's (8, 96, 96), for one).

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD, _TRAIN, _STAGED = "fourier_unit_fwd", "fourier_unit_train", "fourier_unit_staged"
_ENTRY_POINTS = {
    _FWD: {
        "ffc_fourier_unit_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "ffc_fu_item_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    _TRAIN: {
        "ffc_fu_train_stats": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "ffc_fu_bwd_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
        "ffc_fu_item_train_stats": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "ffc_fu_item_bwd_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
        "ffc_fu_bwd_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
        "ffc_fu_item_bwd_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
        "ffc_fu_reduce": [_P, _I, _I, _LL, _I, _I, _P, _P],
    },
    _STAGED: {
        "ffc_fu_spectrum": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "ffc_fu_inverse": [_I, _P, _P, _I, _I, _I, _I, _P],
        "ffc_fu_mix_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "ffc_fu_bwd_mix": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _P],
        "ffc_fu_mix_stats": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "ffc_fu_bwd_stats_mix": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
    },
}
# The export of each clustered kernel's per-rank plan, by library and by
# the kernel's name in _item_rank_floats.
_RANK_FLOATS = {
    _FWD: {"forward": "ffc_item_rank_floats"},
    _TRAIN: {"bwd_apply": "ffc_item_rank_floats",
             "train_stats": "ffc_item_train_stats_rank_floats",
             "bwd_stats": "ffc_item_bwd_stats_rank_floats"},
}


@functools.cache
def _library(stem: str) -> ctypes.CDLL:
    lib = _build.library(stem)
    lib.ffc_allow_smem.argtypes = [_I, _I]
    lib.ffc_allow_smem.restype = _I
    lib.ffc_error_string.argtypes = [_I]
    lib.ffc_error_string.restype = ctypes.c_char_p
    for name, argtypes in _ENTRY_POINTS[stem].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    if stem in (_FWD, _TRAIN):
        lib.ffc_item_floats.argtypes = [_I, _I, _I]
        lib.ffc_item_floats.restype = _LL
        for name in _RANK_FLOATS[stem].values():
            getattr(lib, name).argtypes = [_I, _I, _I, _I]
            getattr(lib, name).restype = _LL
    return lib


def _raise_on(stem: str, err: int, what: str) -> None:
    if err != 0:
        message = _library(stem).ffc_error_string(err).decode()
        raise RuntimeError(f"FourierUnit kernel {what} failed: {message}")


@functools.cache
def _smem_limit(stem: str, device_index: int, dtype_code: int) -> int:
    """The card's shared memory per block, which the library's kernels of
    the dtype are allowed to take on this device (set once per library,
    device and dtype)."""
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    with torch.cuda.device(device_index):
        _raise_on(stem, _library(stem).ffc_allow_smem(dtype_code, limit), "set-up")
    return limit


def _launch(stem: str, entry: str, on: torch.Tensor, *args) -> None:
    """Calls the entry point on the current stream of ``on``'s device."""
    _raise_on(stem, _build.launch(getattr(_library(stem), entry), on.get_device(), *args),
              "launch")


# --- which design runs a map ------------------------------------------------------

SHARED, STAGED, WORKSPACE = "shared", "staged", "workspace"
# The per-item library of each wrapper that kernel_design serves.
_DESIGN_STEMS = {"forward": _FWD, "bwd_apply": _TRAIN, "stats": _TRAIN}
# Spectral positions per tile of a staged mix stage, and the blocks that
# its grid aims at (about four per SM of an H100).
_TILE, _MIX_BLOCKS = 64, 512


def _item_floats(stem: str, c: int, h: int, w: int) -> int:
    """Floats of one item's buffers in a workspace kernel of ``stem``: the
    ``Plan`` of csrc/fourier_unit_fwd.cu or csrc/fourier_unit_train.cu,
    which :func:`kernel_design` holds against a block's shared memory."""
    wf = w // 2 + 1
    n_spec, n_map, c2 = c * h * wf, c * h * w, 2 * c
    pair_or_map = max(n_map, 2 * n_spec)
    tables = 2 * w * wf + 2 * h * h
    if stem == _FWD:  # two buffers, tables, K, mean/inv/scale/bias, c
        return 2 * n_spec + pair_or_map + tables + c2 * c2 + 4 * c2 + wf
    # three buffers, tables, K, six (2C,) vectors, c
    return 4 * n_spec + pair_or_map + tables + c2 * c2 + 6 * c2 + wf


def _staged_smem(c: int, h: int, w: int) -> int:
    """Bytes of shared memory the largest staged kernel of the map takes:
    one plane's H x Wf complex values with its twiddles, or the backward
    mix stage's K, two tiles and six (2C,) vectors
    (csrc/fourier_unit_staged.cu)."""
    c2 = 2 * c
    plane = (h * (w // 2 + 1) + w // 2 + h // 2) * 8
    mix = (c2 * (c2 + 1) + 2 * c2 * (_TILE + 1) + 6 * c2) * 4
    return max(plane, mix)


@functools.cache
def kernel_design(wrapper: str, c: int, h: int, w: int, smem_limit: int) -> str:
    """How ``wrapper`` ("forward" for :func:`fourier_unit_forward`,
    "bwd_apply" for :func:`fu_bwd_apply`, "stats" for :func:`fu_train_stats`,
    :func:`fu_bwd_stats` and the training op) runs the map (C, H, W) on a
    card whose blocks may take ``smem_limit`` bytes of shared memory; a
    fixed rule, not a knob:

    - ``SHARED``: the wrapper's clustered per-item kernel, its item's
      buffers in shared memory, wherever the workspace kernel's plan
      (``_item_floats``) fits the limit (:func:`item_design` then picks
      ranks whose plans fit);
    - ``STAGED``: else the staged kernels, wherever they take the map: H and
      W powers of two (at least 4), 2C one of 16, 32, 64, 128, and their
      shared memory (``_staged_smem``) within the limit;
    - ``SHARED``: else the clustered kernel wherever one rank's plan
      (``_item_rank_floats``) fits the limit on some cluster of
      ``_ITEM_RANKS`` ranks that divides C, for every kernel the wrapper's
      design covers: the forward's own plan, or the backward apply's and
      the statistics' together;
    - ``WORKSPACE``: else the per-item workspace kernel, the item's
      buffers in a device workspace, which takes any map.

    The statistics and the backward apply are decided on the same plans,
    so the two always take the same design. At 227 KB (an H100) the 32px
    generator's maps stay ``SHARED``, and so does the forward at (64, 16,
    16); the 128px generator's maps at 32x32 to 128x128, and the backward
    apply and the statistics at (64, 16, 16), are ``STAGED``; the 48px
    generator's (8, 48, 48), whose one-block plan of the backward exceeds
    the limit, is ``SHARED`` on clusters of 2 ranks or more; (8, 96, 96)
    and (32, 256, 256) are ``WORKSPACE``."""
    if _item_floats(_DESIGN_STEMS[wrapper], c, h, w) * 4 <= smem_limit:
        return SHARED
    pow2 = lambda v: v >= 4 and v & (v - 1) == 0
    if pow2(h) and pow2(w) and 2 * c in (16, 32, 64, 128) and _staged_smem(c, h, w) <= smem_limit:
        return STAGED
    plans = ("forward",) if wrapper == "forward" else ("bwd_apply", "stats")
    if any(c % r == 0 and all(_item_rank_floats(k, c, h, w, r) * 4 <= smem_limit for k in plans)
           for r in _ITEM_RANKS):
        return SHARED
    return WORKSPACE


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _item_rank_floats(kernel: str, c: int, h: int, w: int, ranks: int) -> int:
    """Floats of shared memory one rank of a clustered per-item kernel takes
    on a cluster of ``ranks``: ``kernel`` "forward" (``ItemPlan`` of
    csrc/fourier_unit_fwd.cu), "bwd_apply", "train_stats" or "bwd_stats"
    (``ItemPlan``, ``TrainStatsPlan``, ``BwdStatsPlan`` of
    csrc/fourier_unit_train.cu; 16-byte aligned regions), or "stats", the
    larger of the statistics' two. Per rank: two (forward, statistics) or
    three spectrum-pair buffers of its C/R channels, on more than one rank
    the item's whole spectrum gathered from the ranks, the tables, one or
    two (2C, 2C/R) slices of K and, in all but the statistics, four
    (forward, backward sums) or six (backward apply) (2C/R,) vectors and
    the half-spectrum weights."""
    if kernel == "stats":
        return max(_item_rank_floats(k, c, h, w, ranks) for k in ("train_stats", "bwd_stats"))
    wf = w // 2 + 1
    cr = c // ranks
    buf = _round4(2 * cr * h * wf)
    shared = (_round4(2 * c * h * wf) if ranks > 1 else 0) + _round4(2 * w * wf + 2 * h * h)
    kslice = _round4(4 * c * cr)
    buffers, kslices, vectors = {"forward": (2, 1, 4), "train_stats": (2, 1, 0),
                                 "bwd_stats": (3, 1, 4), "bwd_apply": (3, 2, 6)}[kernel]
    return (buffers * buf + shared + kslices * kslice
            + (_round4(2 * vectors * cr) + wf if vectors else 0))


# The cluster sizes of the clustered per-item kernels.
_ITEM_RANKS = (1, 2, 4, 8)


@functools.cache
def item_design(b: int, c: int, h: int, w: int, smem_limit: int) -> int:
    """Ranks R of the thread-block cluster on which the clustered per-item
    kernels run each item of a (B, C, H, W) map; a fixed
    rule, not a knob. R is one of 1, 2, 4, 8 and divides C, and each rank's
    plan (``_item_rank_floats``) of every kernel that :func:`kernel_design`
    sends to ``SHARED`` at this map fits ``smem_limit``; of those, the most
    ranks whose B·R blocks make one wave of one block per SM of an H100
    (B·R <= 132), else the fewest. A rank's stages keep its SM's issue
    slots busy, so two blocks on one SM take twice as long: a second wave
    costs more than the ranks save (``tools/item_design_sweep.py``). Where
    :func:`kernel_design` sent a map to ``SHARED`` on the per-rank plans
    alone, one rank does not fit, so R is at least 2: (64, 8, 48, 48)
    takes 2 (128 blocks, 221,348 B a rank of the backward apply), batch 1
    and 7 take 8. Raises where no R fits."""
    kernels = [k for k in ("forward", "bwd_apply", "stats")
               if kernel_design(k, c, h, w, smem_limit) == SHARED]
    fits = [r for r in _ITEM_RANKS
            if c % r == 0 and all(_item_rank_floats(k, c, h, w, r) * 4 <= smem_limit
                                  for k in kernels)]
    if not fits:
        raise ValueError(f"no cluster of 1-8 ranks fits the map ({c}, {h}, {w}) in "
                         f"{smem_limit} bytes of shared memory per rank")
    return max((r for r in fits if b * r <= _SMS), default=fits[0])


@functools.cache
def _item_tables(h: int, w: int, device_index: int) -> torch.Tensor:
    """The clustered per-item kernels' DFT factor tables on CUDA device
    ``device_index``, built once per (H, W) and device: the plain version's
    f32 factor matrices (``forward_factors``) as [cw | dw | ah | bh]
    (csrc/fourier_unit_item.cuh)."""
    ah, bh, cw, dw = forward_factors(h, w)
    flat = np.concatenate([m.ravel() for m in (cw, dw, ah, bh)])
    return torch.from_numpy(flat).to(torch.device("cuda", device_index))


def staged_chunks(b: int, h: int, w: int) -> int:
    """Runs of tiles per item in a staged mix stage: enough blocks to fill
    the card (``_MIX_BLOCKS`` over the batch), at most one tile each. The
    backward's gK partial sums have B times this many rows."""
    tiles = -(-h * (w // 2 + 1) // _TILE)
    return min(tiles, max(1, -(-_MIX_BLOCKS // b)))


# fu_reduce's launch: an H100's SMs; the rows a block of a cluster takes at
# least (two per warp of its 256 threads); the largest portable cluster.
_SMS, _REDUCE_MIN_ROWS, _CLUSTER_MAX = 132, 16, 8


@functools.cache
def reduce_design(rows: int, cols: int, moments: bool, aligned: bool = True):
    """``(vec, cluster)`` of :func:`fu_reduce`'s kernel on (rows, cols)
    partial sums (with the mean/variance epilogue when ``moments``); a
    fixed rule, not a knob. A block sums a tile of 32·vec columns (of each
    half with ``moments``): vec 4, float4 loads, where the reduced width is
    a multiple of 4 and ``aligned`` (the data 16-byte aligned), else 1. The
    rows of a tile are split over a cluster of blocks, doubled from 1 up to
    8 while the tiles times twice the cluster still fit the SMs and each
    block keeps at least 16 rows."""
    n = cols // 2 if moments else cols
    vec = 4 if aligned and n % 4 == 0 else 1
    tiles = -(-n // (32 * vec))
    cluster = 1
    while (cluster < _CLUSTER_MAX and tiles * cluster * 2 <= _SMS
           and rows >= 2 * cluster * _REDUCE_MIN_ROWS):
        cluster *= 2
    return vec, cluster


def _design(wrapper: str, x: torch.Tensor) -> str:
    limit = _smem_limit(_DESIGN_STEMS[wrapper], x.device.index, _DTYPE_CODES[x.dtype])
    return kernel_design(wrapper, *x.shape[1:], limit)


def _contiguous(*tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the FourierUnit kernels take contiguous tensors")


def _item_launch(stem: str, x: torch.Tensor):
    """(ranks, tables) of a clustered per-item kernel's launch on x's map."""
    b, c, h, w = x.shape
    limit = _smem_limit(stem, x.device.index, _DTYPE_CODES[x.dtype])
    return item_design(b, c, h, w, limit), _item_tables(h, w, x.device.index)


def _workspace(stem: str, x: torch.Tensor) -> torch.Tensor:
    """A workspace kernel's f32 workspace, B items of the plan's floats, from
    PyTorch's allocator, which raises if it cannot be had."""
    return torch.empty(x.shape[0] * _item_floats(stem, *x.shape[1:]), device=x.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _counted(fn):
    fn.launches = 0
    fn.launches_by_map = collections.Counter()
    return fn


def _count(fn, key) -> None:
    fn.launches += 1
    fn.launches_by_map[key] += 1


# --- kernel wrappers --------------------------------------------------------------


@_counted
def fourier_unit_forward(x, kernel, scale, bias, mean, var):
    """FourierUnit forward with the given statistics; on CUDA the clustered
    per-item kernel (:func:`item_design` ranks per item), the staged
    kernels or the workspace kernel, as :func:`kernel_design` picks, on the
    CPU the plain version. Returns y with x's shape and dtype."""
    _check_args(x, kernel, scale=scale, bias=bias, mean=mean, var=var)
    if x.device.type == "cpu":
        return fourier_unit_forward_plain(x, kernel, scale, bias, mean, var)
    b, c, h, w = x.shape
    if b == 0:
        return torch.empty_like(x)
    design = _design("forward", x)
    if design == STAGED:
        z = fu_spectrum(x)[0]
        return fu_inverse(fu_mix_apply(z, kernel, scale, bias, mean, var), x.dtype, w)
    _contiguous(x, kernel, scale, bias, mean, var)
    y = torch.empty_like(x)
    vectors = (scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr())
    if design == SHARED:
        ranks, tables = _item_launch(_FWD, x)
        _launch(_FWD, "ffc_fu_item_fwd", x, _DTYPE_CODES[x.dtype], x.data_ptr(),
                kernel.data_ptr(), tables.data_ptr(), *vectors, y.data_ptr(), b, c, h, w, ranks)
    else:
        ws = _workspace(_FWD, x)
        _launch(_FWD, "ffc_fourier_unit_fwd", x, _DTYPE_CODES[x.dtype], x.data_ptr(),
                kernel.data_ptr(), *vectors, y.data_ptr(), ws.data_ptr(), b, c, h, w)
    _count(fourier_unit_forward, (c, h, w))
    return y


@_counted
def fu_reduce(partial, count=0):
    """Fixed-order sum over the rows of ``partial`` (rows, cols) f32, with
    the mean/variance epilogue when ``count`` > 0 (see
    :func:`fu_reduce_plain`); the kernel on CUDA."""
    if partial.dim() != 2 or partial.dtype != torch.float32:
        raise ValueError(f"partial must be 2-D float32, got {tuple(partial.shape)} {partial.dtype}")
    if count and partial.shape[1] % 2:
        raise ValueError("the mean/variance epilogue needs an even column count")
    if partial.device.type == "cpu":
        return fu_reduce_plain(partial, count)
    if not partial.is_contiguous():
        raise ValueError("the FourierUnit kernels take contiguous tensors")
    return _reduce(partial, count, partial.data_ptr() % 16 == 0)


@functools.cache
def _reduce_entry():
    return _library(_TRAIN).ffc_fu_reduce


def _reduce(partial, count=0, aligned=True):
    """:func:`fu_reduce` for the port's own callers, which pass a
    ``partial`` they built themselves (a fresh contiguous (rows, cols) f32
    tensor, so 16-byte aligned) and an even column count with ``count``:
    nothing is checked again. The plain version on the CPU."""
    if not partial.is_cuda:
        return fu_reduce_plain(partial, count)
    rows, cols = partial.shape
    out = partial.new_empty(cols)
    vec, cluster = reduce_design(rows, cols, count > 0, aligned)
    err = _build.launch(_reduce_entry(), partial.get_device(), partial.data_ptr(), rows, cols,
                        count, vec, cluster, out.data_ptr())
    if err:
        _raise_on(_TRAIN, err, "launch")
    fu_reduce.launches += 1
    fu_reduce.launches_by_map[(rows, cols)] += 1
    return out


@_counted
def fu_train_stats(x, kernel):
    """(bmean, bvar) of m over (B, H, Wf), f32; on CUDA the clustered
    per-item kernel (:func:`item_design` ranks per item) or the workspace
    kernel, each with ``fu_reduce``, or the staged kernels (``fu_spectrum``,
    ``fu_mix_stats``), as :func:`kernel_design` picks; on the CPU the plain
    version."""
    _check_args(x, kernel)
    if x.device.type == "cpu":
        return fu_train_stats_plain(x, kernel)
    design = _design("stats", x)
    if design == STAGED:
        return fu_mix_stats(fu_spectrum(x)[0], kernel)
    _contiguous(x, kernel)
    b, c, h, w = x.shape
    partial = torch.empty(b, 4 * c, device=x.device)
    operands = (_DTYPE_CODES[x.dtype], x.data_ptr(), kernel.data_ptr())
    if design == SHARED:
        ranks, tables = _item_launch(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_item_train_stats", x, *operands, tables.data_ptr(),
                partial.data_ptr(), b, c, h, w, ranks)
    else:
        ws = _workspace(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_train_stats", x, *operands, partial.data_ptr(), ws.data_ptr(),
                b, c, h, w)
    _count(fu_train_stats, (c, h, w))
    return _reduce(partial, b * h * (w // 2 + 1)).split(2 * c)


@_counted
def fu_bwd_stats(x, kernel, scale, bias, bmean, bvar, gy):
    """(gscale, gbias) = (Σ gpre·n̂, Σ gpre), f32; on CUDA the clustered
    per-item kernel (:func:`item_design` ranks per item) or the workspace
    kernel, each with ``fu_reduce``, or the staged kernels (``fu_spectrum``
    of x and gy, ``fu_bwd_stats_mix``), as :func:`kernel_design` picks; on
    the CPU the plain version."""
    _check_args(x, kernel, scale=scale, bias=bias, bmean=bmean, bvar=bvar, gy=gy)
    if x.device.type == "cpu":
        return fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)
    design = _design("stats", x)
    if design == STAGED:
        z, g = fu_spectrum(x, gy)
        return fu_bwd_stats_mix(z, g, kernel, scale, bias, bmean, bvar)
    _contiguous(x, kernel, scale, bias, bmean, bvar, gy)
    b, c, h, w = x.shape
    partial = torch.empty(b, 4 * c, device=x.device)
    operands = (_DTYPE_CODES[x.dtype], x.data_ptr(), gy.data_ptr(), kernel.data_ptr())
    vectors = (scale.data_ptr(), bias.data_ptr(), bmean.data_ptr(), bvar.data_ptr())
    if design == SHARED:
        ranks, tables = _item_launch(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_item_bwd_stats", x, *operands, tables.data_ptr(), *vectors,
                partial.data_ptr(), b, c, h, w, ranks)
    else:
        ws = _workspace(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_bwd_stats", x, *operands, *vectors, partial.data_ptr(),
                ws.data_ptr(), b, c, h, w)
    _count(fu_bwd_stats, (c, h, w))
    return _reduce(partial).split(2 * c)


@_counted
def fu_bwd_apply(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias):
    """(gx like x, gK (2C, 2C) f32) of the train-mode backward; on CUDA the
    clustered per-item kernel (:func:`item_design` ranks per item), the
    staged kernels or the workspace kernel, as :func:`kernel_design` picks,
    with ``fu_reduce``; on the CPU the plain version."""
    _check_args(x, kernel, scale=scale, bias=bias, bmean=bmean, bvar=bvar, gy=gy,
                gscale=gscale, gbias=gbias)
    if x.device.type == "cpu":
        return fu_bwd_apply_plain(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias)
    design = _design("bwd_apply", x)
    if design == STAGED:
        z, g = fu_spectrum(x, gy)
        gz, gk = fu_bwd_mix(z, g, kernel, scale, bias, bmean, bvar, gscale, gbias)
        return fu_inverse(gz, x.dtype, x.shape[3]), gk
    _contiguous(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias)
    b, c, h, w = x.shape
    gx = torch.empty_like(x)
    partial = torch.empty(b, 4 * c * c, device=x.device)
    operands = (x.data_ptr(), gy.data_ptr(), kernel.data_ptr())
    vectors = (scale.data_ptr(), bias.data_ptr(), bmean.data_ptr(), bvar.data_ptr(),
               gscale.data_ptr(), gbias.data_ptr())
    if design == SHARED:
        ranks, tables = _item_launch(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_item_bwd_apply", x, _DTYPE_CODES[x.dtype], *operands,
                tables.data_ptr(), *vectors, gx.data_ptr(), partial.data_ptr(), b, c, h, w,
                ranks)
    else:
        ws = _workspace(_TRAIN, x)
        _launch(_TRAIN, "ffc_fu_bwd_apply", x, _DTYPE_CODES[x.dtype], *operands, *vectors,
                gx.data_ptr(), partial.data_ptr(), ws.data_ptr(), b, c, h, w)
    _count(fu_bwd_apply, (c, h, w))
    return gx, _reduce(partial).view(2 * c, 2 * c)


# --- the staged kernels' wrappers -----------------------------------------------------


def _check_stage(specs, kernel=None, **vectors):
    """Checks a staged kernel's operands: (B, 2C, H, Wf) f32 spectra of one
    shape, K (2C, 2C) f32 or bf16, (2C,) f32 vectors, all on one device and,
    on CUDA, contiguous."""
    z = specs[0]
    if z.dim() != 4 or z.shape[1] % 2 or z.dtype != torch.float32:
        raise ValueError(f"a spectrum must be (B, 2C, H, Wf) float32, got "
                         f"{tuple(z.shape)} {z.dtype}")
    if any(s.shape != z.shape or s.dtype != z.dtype for s in specs):
        raise ValueError("the spectra must share one shape and dtype")
    c2 = z.shape[1]
    if kernel is not None and (kernel.shape != (c2, c2) or kernel.dtype not in _DTYPE_CODES):
        raise ValueError(f"kernel must be ({c2}, {c2}) float32 or bfloat16, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    for name, t in vectors.items():
        if t.shape != (c2,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({c2},) float32, got {tuple(t.shape)} {t.dtype}")
    tensors = [*specs, *([] if kernel is None else [kernel]), *vectors.values()]
    if any(t.device != z.device for t in tensors):
        raise ValueError("all FourierUnit operands must be on one device")
    if z.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the FourierUnit kernels take contiguous tensors")


def _spectrum_map(spec):
    """(C, H, W) of a (B, 2C, H, Wf) spectrum of an even W."""
    return spec.shape[1] // 2, spec.shape[2], 2 * (spec.shape[3] - 1)


def _staged_launch(entry: str, on: torch.Tensor, dtype: torch.dtype, *args) -> None:
    code = _DTYPE_CODES[dtype]
    _smem_limit(_STAGED, on.device.index, code)
    _launch(_STAGED, entry, on, code, *args)


@_counted
def fu_spectrum(*maps):
    """[re; im] rfft2 of each (B, C, H, W) map (one or two, of one shape and
    dtype), stacked: (len(maps), B, 2C, H, Wf) f32; one launch of the
    staged spectrum kernel on CUDA, the plain version on the CPU."""
    x = maps[0]
    if not 1 <= len(maps) <= 2 or any(m.shape != x.shape or m.dtype != x.dtype for m in maps):
        raise ValueError("fu_spectrum takes one or two maps of one shape and dtype")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"a map must be (B, C, H, W) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if any(m.device != x.device for m in maps):
        raise ValueError("all FourierUnit operands must be on one device")
    if x.device.type == "cpu":
        return fu_spectrum_plain(*maps)
    if not all(m.is_contiguous() for m in maps):
        raise ValueError("the FourierUnit kernels take contiguous tensors")
    b, c, h, w = x.shape
    out = torch.empty(len(maps), b, 2 * c, h, w // 2 + 1, device=x.device)
    _staged_launch("ffc_fu_spectrum", x, x.dtype, x.data_ptr(), maps[-1].data_ptr(),
                   out.data_ptr(), len(maps), b, c, h, w)
    _count(fu_spectrum, (c, h, w))
    return out


@_counted
def fu_mix_apply(z, kernel, scale, bias, mean, var):
    """r = c·ReLU(BN(z mixed by kernel)) with the given statistics, f32 like
    z; the staged mix kernel on CUDA, the plain version on the CPU."""
    _check_stage([z], kernel, scale=scale, bias=bias, mean=mean, var=var)
    if z.device.type == "cpu":
        return fu_mix_apply_plain(z, kernel, scale, bias, mean, var)
    (c, h, w), b = _spectrum_map(z), z.shape[0]
    r = torch.empty_like(z)
    _staged_launch("ffc_fu_mix_apply", z, kernel.dtype, z.data_ptr(), kernel.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
                   r.data_ptr(), b, c, h, w, staged_chunks(b, h, w))
    _count(fu_mix_apply, (c, h, w))
    return r


@_counted
def fu_mix_stats(z, kernel):
    """(bmean, bvar) of m = z mixed by kernel over (B, H, Wf), f32: the
    staged statistics kernel, which writes B·chunks rows of partial sums,
    and ``fu_reduce`` on CUDA; the plain version on the CPU."""
    _check_stage([z], kernel)
    if z.device.type == "cpu":
        return fu_mix_stats_plain(z, kernel)
    (c, h, w), b = _spectrum_map(z), z.shape[0]
    chunks = staged_chunks(b, h, w)
    partial = torch.empty(b * chunks, 4 * c, device=z.device)
    _staged_launch("ffc_fu_mix_stats", z, kernel.dtype, z.data_ptr(), kernel.data_ptr(),
                   partial.data_ptr(), b, c, h, w, chunks)
    _count(fu_mix_stats, (c, h, w))
    return _reduce(partial, b * h * (w // 2 + 1)).split(2 * c)


@_counted
def fu_bwd_stats_mix(z, g, kernel, scale, bias, bmean, bvar):
    """(gscale, gbias) = (Σ gpre·n̂, Σ gpre) from z and G = DFT(gy), f32:
    the staged backward-sums kernel, which reads G and leaves it as it
    was, and ``fu_reduce`` on CUDA; the plain version on the CPU."""
    _check_stage([z, g], kernel, scale=scale, bias=bias, bmean=bmean, bvar=bvar)
    if z.device.type == "cpu":
        return fu_bwd_stats_mix_plain(z, g, kernel, scale, bias, bmean, bvar)
    (c, h, w), b = _spectrum_map(z), z.shape[0]
    chunks = staged_chunks(b, h, w)
    partial = torch.empty(b * chunks, 4 * c, device=z.device)
    _staged_launch("ffc_fu_bwd_stats_mix", z, kernel.dtype, z.data_ptr(), g.data_ptr(),
                   kernel.data_ptr(), scale.data_ptr(), bias.data_ptr(), bmean.data_ptr(),
                   bvar.data_ptr(), partial.data_ptr(), b, c, h, w, chunks)
    _count(fu_bwd_stats_mix, (c, h, w))
    return _reduce(partial).split(2 * c)


@_counted
def fu_inverse(spec, dtype, w):
    """Re(eh · R · fwᵀ) of each plane of the (B, 2C, H, Wf) f32 spectrum,
    without half-spectrum weights: (B, C, H, W) in ``dtype``; the staged
    inverse kernel on CUDA, the plain version on the CPU."""
    _check_stage([spec])
    if w // 2 + 1 != spec.shape[3] or dtype not in _DTYPE_CODES:
        raise ValueError(f"no float32 or bfloat16 map of width {w} has this spectrum")
    if spec.device.type == "cpu":
        return fu_inverse_plain(spec, dtype, w)
    b, c2, h, _ = spec.shape
    y = torch.empty(b, c2 // 2, h, w, dtype=dtype, device=spec.device)
    _staged_launch("ffc_fu_inverse", spec, dtype, spec.data_ptr(), y.data_ptr(), b, c2 // 2,
                   h, w)
    _count(fu_inverse, (c2 // 2, h, w))
    return y


@_counted
def fu_bwd_mix(z, g, kernel, scale, bias, bmean, bvar, gscale, gbias):
    """(gz f32, gK (2C, 2C) f32) of the backward apply from z and G =
    DFT(gy): the staged mix kernel, which writes gz over g, and
    ``fu_reduce`` on CUDA; the plain version on the CPU."""
    _check_stage([z, g], kernel, scale=scale, bias=bias, bmean=bmean, bvar=bvar,
                 gscale=gscale, gbias=gbias)
    if z.device.type == "cpu":
        return fu_bwd_mix_plain(z, g, kernel, scale, bias, bmean, bvar, gscale, gbias)
    (c, h, w), b = _spectrum_map(z), z.shape[0]
    chunks = staged_chunks(b, h, w)
    partial = torch.empty(b * chunks, 4 * c * c, device=z.device)
    _staged_launch("ffc_fu_bwd_mix", z, kernel.dtype, z.data_ptr(), g.data_ptr(),
                   kernel.data_ptr(), scale.data_ptr(), bias.data_ptr(), bmean.data_ptr(),
                   bvar.data_ptr(), gscale.data_ptr(), gbias.data_ptr(), partial.data_ptr(),
                   b, c, h, w, chunks)
    _count(fu_bwd_mix, (c, h, w))
    return g, _reduce(partial).view(2 * c, 2 * c)


# --- the autograd Functions -----------------------------------------------------


def _train_forward_staged(x, kernel, scale, bias):
    """The training forward on the staged kernels, ``(y, bmean, bvar)``: one
    spectrum of x feeds the statistics stage and then the apply stage."""
    z = fu_spectrum(x)[0]
    bmean, bvar = fu_mix_stats(z, kernel)
    r = fu_mix_apply(z, kernel, scale, bias, bmean, bvar)
    return fu_inverse(r, x.dtype, x.shape[3]), bmean, bvar


def _train_backward_staged(x, kernel, scale, bias, bmean, bvar, gy, train=True):
    """The backward on the staged kernels, ``(gx, gK in kernel's dtype,
    gscale, gbias)``: one launch transforms x and gy, and the backward sums
    read G before ``fu_bwd_mix`` writes gz over it. In eval mode
    (``train`` False) the mix stage takes zero sums, which leaves gm =
    gn·inv."""
    z, g = fu_spectrum(x, gy)
    gscale, gbias = fu_bwd_stats_mix(z, g, kernel, scale, bias, bmean, bvar)
    sums = (gscale, gbias) if train else (torch.zeros_like(gscale),) * 2
    gz, gk = fu_bwd_mix(z, g, kernel, scale, bias, bmean, bvar, *sums)
    return fu_inverse(gz, x.dtype, x.shape[3]), gk.to(kernel.dtype), gscale, gbias


def _stats_staged(x) -> bool:
    return x.device.type == "cuda" and _design("stats", x) == STAGED


def _backward_kernels(x, kernel, scale, bias, bmean, bvar, gy, train):
    """``(gx, gK in kernel's dtype, gscale, gbias)`` from the kernels (the
    plain versions on the CPU); in eval mode the apply takes zero sums, so
    the coupled-BN cotangent collapses to gm = gn·inv."""
    if _stats_staged(x):
        return _train_backward_staged(x, kernel, scale, bias, bmean, bvar, gy, train)
    gscale, gbias = fu_bwd_stats(x, kernel, scale, bias, bmean, bvar, gy)
    sums = (gscale, gbias) if train else (torch.zeros_like(gscale),) * 2
    gx, gk = fu_bwd_apply(x, kernel, scale, bias, bmean, bvar, gy, *sums)
    return gx, gk.to(kernel.dtype), gscale, gbias


class _FourierUnitBackward(torch.autograd.Function):
    """The op's first-order backward ``(gx, gK, gscale, gbias)`` as a
    function of (x, kernel, scale, bias, gy): the kernels compute it, and
    its own backward (the second-order term, which a gradient penalty
    needs) is the VJP of the plain backward, as the JAX package
    differentiates its jnp backward. In training the batch statistics are
    recomputed from (x, kernel) there, so the term includes their
    dependence on both; the running statistics of eval mode get none."""

    @staticmethod
    def forward(ctx, x, kernel, scale, bias, bmean, bvar, gy, train):
        ctx.save_for_backward(x, kernel, scale, bias, bmean, bvar, gy)
        ctx.train = train
        return _backward_kernels(x, kernel, scale, bias, bmean, bvar, gy, train)

    @staticmethod
    def backward(ctx, ggx, ggk, ggscale, ggbias):
        x, kernel, scale, bias, bmean, bvar, gy = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x, kernel, scale, bias, gy)]
        xd, kd, sd, bd, gyd = inputs
        with torch.enable_grad():
            if ctx.train:
                bmean, bvar = fu_train_stats_plain(xd, kd)
            outs = fourier_unit_backward_plain(xd, kd, sd, bd, bmean, bvar, gyd, ctx.train)[:4]
            grads = torch.autograd.grad(outs, inputs, (ggx, ggk, ggscale, ggbias),
                                        allow_unused=True)
        gx, gk, gscale, gbias, ggy = grads
        return gx, gk, gscale, gbias, None, None, ggy, None


class _FourierUnitTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, scale, bias):
        if _stats_staged(x):
            y, bmean, bvar = _train_forward_staged(x, kernel, scale, bias)
        else:
            bmean, bvar = fu_train_stats(x, kernel)
            y = fourier_unit_forward(x, kernel, scale, bias, bmean, bvar)
        ctx.save_for_backward(x, kernel, scale, bias, bmean, bvar)
        ctx.mark_non_differentiable(bmean, bvar)
        return y, bmean, bvar

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):  # the statistics' cotangents are dropped
        x, kernel, scale, bias, bmean, bvar = ctx.saved_tensors
        return _FourierUnitBackward.apply(x, kernel, scale, bias, bmean, bvar,
                                          gy.contiguous(), True)


class _FourierUnitEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, scale, bias, mean, var):
        ctx.save_for_backward(x, kernel, scale, bias, mean, var)
        return fourier_unit_forward(x, kernel, scale, bias, mean, var)

    @staticmethod
    def backward(ctx, gy):  # the running statistics get no gradient
        x, kernel, scale, bias, mean, var = ctx.saved_tensors
        return (*_FourierUnitBackward.apply(x, kernel, scale, bias, mean, var,
                                            gy.contiguous(), False), None, None)


def fourier_unit_train(x, kernel, scale, bias):
    """FourierUnit train forward, differentiable (twice) in x, kernel, scale
    and bias: ``(y, bmean, bvar)`` with y normalised by the f32 batch
    statistics of m. Kernels on CUDA, plain versions on the CPU."""
    _check_args(x, kernel, scale=scale, bias=bias)
    return _FourierUnitTrain.apply(x, kernel, scale, bias)


def fourier_unit_eval(x, kernel, scale, bias, mean, var):
    """FourierUnit eval forward with the running statistics ``mean`` and
    ``var``, differentiable (twice) in x, kernel, scale and bias: the
    forward and backward kernels on CUDA (the backward apply with zero
    sums, gm = gn·inv), plain versions on the CPU."""
    _check_args(x, kernel, scale=scale, bias=bias, mean=mean, var=var)
    return _FourierUnitEval.apply(x, kernel, scale, bias, mean, var)
