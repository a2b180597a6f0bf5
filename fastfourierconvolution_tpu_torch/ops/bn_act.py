"""Fused packed BatchNorm + tanh-GELU (+ StyleGAN noise), training mode.

The generator's packed-branch blocks normalise the whole ``[local |
global]`` map with one set of per-channel batch statistics, apply the
tanh-form GELU and, folded into the same pass, the blocks' noise injection
(``nn/ffc.py``, ``models/ffc_gan.py``). This module is that op, with the
JAX package's rounding points: statistics in f32 from the input dtype, the
biased variance E[x²] − E[x]² with no clamp at 0, ``u`` computed in f32 and
cast to x's dtype before the GELU (evaluated in f32 and cast once), the
noise product and add in x's dtype.

Plain PyTorch versions (given float64 operands they compute in float64,
which is how the kernels' reference is taken on the card):

- ``bn_stats_plain``: per-channel mean and biased variance;
- ``bn_gelu_apply_plain``: the apply pass, with the noise fold when ``w``
  is given;
- ``bn_bwd_reduce_plain``: S1 = Σdu, S2 = Σdu·x̂ (and S3 = Σg·n);
- ``bn_bwd_dx_plain``: dx = isc·du + p + q·(x − mean) (and dn_l, dn_g);
- ``bn_gelu_chain_plain`` / ``bn_gelu_noise_chain_plain``: the forward.

Kernel wrappers, ``csrc/bn_act.cu``: ``bn_stats``, ``bn_gelu_apply``,
``bn_bwd_reduce`` and ``bn_bwd_dx``. For a CPU tensor each runs its plain
version; for a CUDA tensor it launches its kernel or raises. Each counts
its launches in ``launches`` and, by map (C, H, W), in
``launches_by_map``. ``bn_stats`` goes from x to (mean, var) in one
launch, a thread-block cluster per channel as :func:`stats_design`
picks, and ``bn_bwd_reduce`` from (x, g[, n_l, n_g]) to its sums in one
launch the same way (:func:`bwd_reduce_design`); ``bn_gelu_apply``
launches a grid of position tiles and channel groups that
:func:`apply_design` picks, and ``bn_bwd_dx`` one of the same kind that
:func:`dx_design` picks, whose groups, with the noise fold, are the ranks of
a cluster that sums dn_l and dn_g over every channel.

``packed_bn_gelu(x, scale, bias)`` and ``packed_bn_gelu_noise(x, scale,
bias, w, n_l, n_g, cl)`` are the autograd ops the model calls: each
returns ``(out, bmean, bvar)`` and is differentiable in every tensor
input, the statistics' cotangents included (the JAX package's ``_bwd`` and
``_bwd_noise``).

In a process group (``parallel``) the statistics and the backward sums are
the global batch's: ``bn_stats``'s kernel writes its sums instead of the
moments, ``bn_bwd_reduce``'s its S1-S3, and both are gathered from the
processes in rank order and reduced by ``fu_reduce`` (with the global
count for the moments); ``bn_bwd_dx`` takes the global count. The training
op returns the parameters' gradients as this process's share of the
global sums, and the statistics' cotangents summed over the processes.

Layout: x and out (B, C, H, W); scale, bias, w and the statistics (C,) f32;
n_l, n_g (B, 1, H, W) in x's dtype, n_l for the channels below ``cl``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import parallel
from . import _build
from .fourier_unit import _CLUSTER_MAX, _SMS, _counted, _count, _ptr, _reduce

EPS = 1e-5
C1 = 0.7978845608028654  # sqrt(2 / pi)
C2 = 0.044715

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --- plain PyTorch versions ---------------------------------------------------


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in float64 when it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _col(t: torch.Tensor) -> torch.Tensor:
    return _f32(t)[:, None, None]


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """0.5·u·(1 + tanh(c1·(u + c2·u³))) evaluated in f32 (f64 for f64) and
    cast once to u's dtype."""
    uf = _f32(u)
    return (0.5 * uf * (1 + torch.tanh(C1 * (uf + C2 * uf * uf * uf)))).to(u.dtype)


def gelu_tanh_grad(u: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / du at u, in f32 (f64 for f64)."""
    uf = _f32(u)
    t = torch.tanh(C1 * (uf + C2 * uf * uf * uf))
    return 0.5 * (1 + t) + 0.5 * uf * (1 - t * t) * C1 * (1 + 3 * C2 * uf * uf)


def _noise_map(n_l, n_g, cl, c):
    """(B, C, H, W): n_l on the channels below cl, n_g from cl on."""
    b, _, h, w = n_l.shape
    return torch.cat([n_l.expand(b, cl, h, w), n_g.expand(b, c - cl, h, w)], dim=1)


def _affine(x, mean, var, scale, bias):
    """(x − mean in f32, inv, isc, u = T((x − mean)·isc + bias))."""
    inv = torch.rsqrt(var + EPS)
    isc = inv * scale
    xm = _f32(x) - _col(mean)
    return xm, inv, isc, (xm * _col(isc) + _col(bias)).to(x.dtype)


def bn_stats_plain(x):
    """(mean, var): f32 per-channel mean and biased variance E[x²] − E[x]²
    over (B, H, W) (the global batch's under a process group,
    ``parallel.batch_moments``)."""
    return parallel.batch_moments(_f32(x))


def bn_gelu_apply_plain(x, mean, var, scale, bias, w=None, n_l=None, n_g=None, cl=None):
    """gelu(BN(x)) like x; with ``w``, plus T(w)·n (n = n_l below cl, n_g
    from cl on), in x's dtype."""
    out = gelu_tanh(_affine(x, mean, var, scale, bias)[3])
    if w is None:
        return out
    return out + w.to(x.dtype)[:, None, None] * _noise_map(n_l, n_g, cl, x.shape[1])


def bn_bwd_reduce_plain(x, g, mean, var, scale, bias, n_l=None, n_g=None, cl=None,
                        sum_dtype=None):
    """(S1, S2) = (Σdu, Σdu·x̂) per channel, du = g·gelu'(u), f32; with
    the noise maps also S3 = Σg·n; over the global batch under a process
    group. With ``sum_dtype`` (float64) du, x̂ and
    the sums are taken in that dtype from the op's own u: a reference for
    the kernel's f32 sums that keeps the op's rounding of u."""
    xm, inv, _, u = _affine(x, mean, var, scale, bias)
    cast = _f32 if sum_dtype is None else (lambda t: t.to(sum_dtype))
    gf = cast(g)
    du = gf * gelu_tanh_grad(cast(u))
    sums = [du.sum(dim=(0, 2, 3)), (du * (cast(xm) * _col(cast(inv)))).sum(dim=(0, 2, 3))]
    if n_l is not None:
        sums.append((gf * cast(_noise_map(n_l, n_g, cl, x.shape[1]))).sum(dim=(0, 2, 3)))
    return tuple(parallel.sum_over_processes(torch.stack(sums)))


def bn_bwd_dx_plain(x, g, mean, var, scale, bias, s1, s2, g_mean=None, g_var=None,
                    w=None, cl=None):
    """dx like x (the coupled BN backward with the statistics' cotangents
    g_mean, g_var, None for zero; under a process group s1, s2 and the
    count are the global batch's); with ``w`` also (dn_l, dn_g), the
    per-row sums of g·w below and from cl, (B, 1, H, W) like x."""
    n = parallel.global_count(x.numel() // x.shape[1])
    xm, inv, isc, u = _affine(x, mean, var, scale, bias)
    p, q = -isc * s1, -isc * inv * s2
    if g_mean is not None:
        p = p + g_mean
    if g_var is not None:
        q = q + 2 * g_var
    gf = _f32(g)
    du = gf * gelu_tanh_grad(u)
    dx = (_col(isc) * du + _col(p / n) + _col(q / n) * xm).to(x.dtype)
    if w is None:
        return dx
    gw = gf * _col(w)
    return (dx, gw[:, :cl].sum(dim=1, keepdim=True).to(x.dtype),
            gw[:, cl:].sum(dim=1, keepdim=True).to(x.dtype))


def bn_gelu_chain_plain(x, scale, bias):
    """The forward of :func:`packed_bn_gelu`: ``(out, bmean, bvar)``."""
    mean, var = bn_stats_plain(x)
    return bn_gelu_apply_plain(x, mean, var, scale, bias), mean, var


def bn_gelu_noise_chain_plain(x, scale, bias, w, n_l, n_g, cl):
    """The forward of :func:`packed_bn_gelu_noise`: ``(out, bmean, bvar)``."""
    mean, var = bn_stats_plain(x)
    return bn_gelu_apply_plain(x, mean, var, scale, bias, w, n_l, n_g, cl), mean, var


# --- argument checks ------------------------------------------------------------


def _check(x, maps=(), vectors=(), cl=None):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, c, h, w = x.shape
    for name, t, shape in maps:
        if t.shape != shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {shape} {x.dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in vectors:
        if t is not None and (t.shape != (c,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({c},) float32, got {tuple(t.shape)} {t.dtype}")
    if cl is not None and not 0 <= cl <= c:
        raise ValueError(f"cl must lie in [0, {c}], got {cl}")
    tensors = [x] + [t for _, t, _ in maps] + [t for _, t in vectors if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all BN+GELU operands must be on one device")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the BN+GELU kernels take contiguous tensors")


def _noise_maps(x, n_l, n_g):
    b, _, h, w = x.shape
    return [("n_l", n_l, (b, 1, h, w)), ("n_g", n_g, (b, 1, h, w))]


# --- the CUDA library -------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY_POINTS = {
    "ffc_bn_stats": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ffc_bn_gelu_apply": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    "ffc_bn_bwd_reduce": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                          _P],
    "ffc_bn_bwd_dx": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _LL, _I, _I, _I, _I, _P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("bn_act")
    lib.ffc_bn_gelu_apply_blocks_per_sm.argtypes = [_I, _I, _I, _I]
    lib.ffc_bn_gelu_apply_blocks_per_sm.restype = _I
    lib.ffc_bn_bwd_dx_blocks_per_sm.argtypes = [_I, _I, _I, _I, _I]
    lib.ffc_bn_bwd_dx_blocks_per_sm.restype = _I
    lib.ffc_error_string.argtypes = [_I]
    lib.ffc_error_string.restype = ctypes.c_char_p
    for name, argtypes in _ENTRY_POINTS.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    return lib


def _launch(entry: str, on: torch.Tensor, *args) -> None:
    """Calls the entry point on the current stream of ``on``'s device."""
    err = _build.launch(getattr(_library(), entry), on.get_device(), *args)
    if err != 0:
        message = _library().ffc_error_string(err).decode()
        raise RuntimeError(f"BN+GELU kernel launch failed: {message}")


def _geometry(x):
    """(B, C, H*W) of a (B, C, H, W) map with at least one row, whose rows
    index with 32-bit integers."""
    b, c, h, w = x.shape
    if b * h * w == 0:
        raise ValueError("the BN+GELU kernels need at least one row")
    if b * h * w >= 2**31:
        raise ValueError(f"the BN+GELU kernels take fewer than 2**31 rows, got {b * h * w}")
    return b, c, h * w


def _aligned(*maps) -> bool:
    """Whether every given map starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in maps if t is not None)


# The clustered kernels' launch: eight 256-thread blocks on each SM at once,
# and the least elements of one map a block of a channel's cluster takes.
_RESIDENT_BLOCKS, _STATS_MIN_ELEMENTS = _SMS * 8, 8192


def _cluster_design(b, c, hw, itemsize, aligned, min_elements):
    vec = aligned and hw * itemsize % 16 == 0
    cluster = 1
    while (cluster < _CLUSTER_MAX and c * cluster * 2 <= _RESIDENT_BLOCKS
           and b >= 2 * cluster and b * hw >= 2 * cluster * min_elements):
        cluster *= 2
    return vec, cluster


@functools.cache
def stats_design(b: int, c: int, hw: int, itemsize: int, aligned: bool = True):
    """``(vec, cluster)`` of :func:`bn_stats`'s kernel on a (B, C, H·W) map;
    a fixed rule, not a knob. vec: 16-byte loads where a plane's bytes are
    a multiple of 16 and x is ``aligned`` (16 bytes), else loads of one
    value. Each channel runs on a cluster of blocks that split its B planes,
    doubled from 1 up to 8 while the card still holds every block at once,
    each block keeps at least 8192 elements and at least one plane."""
    return _cluster_design(b, c, hw, itemsize, aligned, _STATS_MIN_ELEMENTS)


@functools.cache
def bwd_reduce_design(b: int, c: int, hw: int, itemsize: int, aligned: bool = True):
    """``(vec, cluster)`` of :func:`bn_bwd_reduce`'s kernel: the rule of
    :func:`stats_design` for a kernel that reads two maps (x and g; and the
    noise maps, 16-byte aligned too when ``aligned``), so a block keeps at
    least 4096 elements, the bytes of bn_stats's 8192."""
    return _cluster_design(b, c, hw, itemsize, aligned, _STATS_MIN_ELEMENTS // 2)


# bn_gelu_apply's launch: what one SM holds at most (32 blocks, 2048
# threads), the largest and the smallest block the kernel takes, and the
# most channels a thread walks.
_SM_BLOCKS, _SM_THREADS = 32, 2048
_APPLY_MAX_TILE, _APPLY_MIN_TILE, _APPLY_MAX_GROUP = 256, 32, 32


def apply_wave(tile: int) -> int:
    """Blocks of ``tile`` threads that 132 SMs hold at once, at most."""
    return _SMS * min(_SM_BLOCKS, _SM_THREADS // tile)


def apply_blocks(b: int, c: int, hw: int, itemsize: int, vec: bool, tile: int, group: int):
    """The apply kernel's grid, (position tiles, channel groups): a thread a
    unit of 16 bytes (``vec``) or of one value of one item's plane."""
    units = b * (hw // (16 // itemsize if vec else 1))
    return -(-units // tile), -(-c // group)


@functools.cache
def apply_design(b: int, c: int, hw: int, itemsize: int, aligned: bool = True):
    """``(vec, tile, group)`` of :func:`bn_gelu_apply`'s kernel on a (B, C,
    H·W) map; a fixed rule, not a knob. vec as in :func:`stats_design`
    (over x, out and the noise maps). tile: threads per block, halved from
    256 while a grid of one channel per thread would hold less than one
    full wave of blocks (:func:`apply_wave`), down to 32; group: channels
    per thread, doubled from 1 up to 32 while the grid keeps at least two
    waves."""
    vec = aligned and hw * itemsize % 16 == 0
    blocks = lambda tile, group: math.prod(apply_blocks(b, c, hw, itemsize, vec, tile, group))
    tile = _APPLY_MAX_TILE
    while tile > _APPLY_MIN_TILE and blocks(tile, 1) < apply_wave(tile):
        tile //= 2
    group = 1
    while group < _APPLY_MAX_GROUP and blocks(tile, 2 * group) >= 2 * apply_wave(tile):
        group *= 2
    return vec, tile, group


def apply_blocks_per_sm(dtype: torch.dtype, noise: bool, vec: bool, tile: int) -> int:
    """Blocks of the built apply kernel that one SM of the current card
    holds at once (CUDA's occupancy calculator)."""
    return _library().ffc_bn_gelu_apply_blocks_per_sm(_DTYPE_CODES[dtype], int(noise),
                                                        int(vec), tile)


# bn_bwd_dx's launch: 256 threads a block (csrc's kThreads); the blocks one
# SM holds of the kernel as built, by the occupancy calculator (H100, sm_90a): 3 with
# 16-byte units (70-80 registers a thread; its __launch_bounds__ keeps 3 at
# least), and for units of one value (40-56 registers, 5-6 blocks) the 8
# that the SM's 2048 threads allow, a count that errs toward more blocks.
# With the noise fold a unit's channels are split over up to a warp of
# threads while one thread would walk more than 16 of them.
_DX_TILE = 256
_DX_BLOCKS_PER_SM = {True: 3, False: 8}
_DX_WARP, _DX_MAX_CHANNELS = 32, 16


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def dx_wave(vec: bool) -> int:
    """Blocks of the dx kernel that 132 SMs hold at once."""
    return _SMS * _DX_BLOCKS_PER_SM[vec]


def dx_blocks(b: int, c: int, hw: int, itemsize: int, vec: bool, lanes: int, group: int,
              cluster: int):
    """The dx kernel's grid, (position tiles, channel groups): 256 //
    ``lanes`` units a block (16 bytes with ``vec``, else one value, of one
    item's plane), ``lanes`` threads a unit; ceil(C / group) groups, or with
    the noise fold (``cluster`` > 1) the cluster's ranks, the last ones
    empty where ``cluster * group`` exceeds C."""
    units = b * (hw // (16 // itemsize if vec else 1))
    return -(-units // (_DX_TILE // lanes)), cluster if cluster > 1 else -(-c // group)


@functools.cache
def dx_design(b: int, c: int, hw: int, itemsize: int, aligned: bool = True,
              noise: bool = False):
    """``(vec, lanes, group, cluster)`` of :func:`bn_bwd_dx`'s kernel on a
    (B, C, H·W) map; a fixed rule, not a knob. vec as in
    :func:`stats_design` (over x, g and dx); 256-thread blocks, whose wave
    is :func:`dx_wave`. Without the noise fold a thread a unit, no cluster,
    and ``group`` channels a block, doubled from 1 while the grid keeps at
    least two waves. With it dn_l and dn_g sum every channel of a unit:
    ``lanes`` threads share the unit, doubled from 1 up to a warp while the
    grid holds less than one wave or a thread walks more than 16 channels;
    then, while the grid still holds less than a wave, the channels are
    split over the ranks of a cluster, doubled from 1 up to 8 (``group`` =
    ceil(C / ranks) channels a rank, at least a channel a lane); then the
    lanes double on, up to one channel a thread."""
    vec = aligned and hw * itemsize % 16 == 0
    wave = dx_wave(vec)
    blocks = lambda lanes, group, cluster: math.prod(
        dx_blocks(b, c, hw, itemsize, vec, lanes, group, cluster))
    short = lambda lanes, group, cluster: blocks(lanes, group, cluster) < wave
    if not noise:
        group = 1
        while group < c and blocks(1, 2 * group, 1) >= 2 * wave:
            group *= 2
        return vec, 1, group, 1
    lanes = cluster = 1
    while lanes < min(_DX_WARP, _pow2_ceil(c)) and (short(lanes, c, 1)
                                                    or -(-c // lanes) > _DX_MAX_CHANNELS):
        lanes *= 2
    while (cluster < min(_CLUSTER_MAX, _pow2_ceil(c)) and -(-c // (2 * cluster)) >= lanes
           and short(lanes, -(-c // cluster), cluster)):
        cluster *= 2
    group = -(-c // cluster)
    while lanes < min(_DX_TILE, _pow2_ceil(group)) and short(lanes, group, cluster):
        lanes *= 2
    return vec, lanes, group, cluster


def dx_blocks_per_sm(dtype: torch.dtype, noise: bool, vec: bool, lanes: int,
                     group: int) -> int:
    """Blocks of the built dx kernel, at the launch (lanes, group) and its
    shared memory, that one SM of the current card holds at once (CUDA's
    occupancy calculator)."""
    return _library().ffc_bn_bwd_dx_blocks_per_sm(_DTYPE_CODES[dtype], int(noise), int(vec),
                                                    lanes, group)


# --- kernel wrappers --------------------------------------------------------------


@_counted
def bn_stats(x):
    """(mean, var) per channel, f32; one launch of the stats kernel on
    CUDA, the plain version on the CPU. Under a process group the kernel
    writes its sums, which are gathered from the processes in rank order
    and turned into the global batch's statistics by ``fu_reduce``."""
    _check(x)
    if x.device.type == "cpu":
        return bn_stats_plain(x)
    b, c, h, w = x.shape
    if b * h * w == 0:
        raise ValueError("the BN+GELU kernels need at least one row")
    vec, cluster = stats_design(b, c, h * w, x.element_size(), _aligned(x))
    out = x.new_empty((2, c), dtype=torch.float32)
    sums = parallel.active()
    _launch("ffc_bn_stats", x, _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), b, c,
            h * w, int(vec), cluster, int(sums))
    _count(bn_stats, (c, h, w))
    if sums:
        rows = parallel.all_gather_rows(out.view(1, 2 * c))
        out = _reduce(rows, parallel.global_count(b * h * w)).view(2, c)
    return out.unbind()


@_counted
def bn_gelu_apply(x, mean, var, scale, bias, w=None, n_l=None, n_g=None, cl=None):
    """The apply pass (see :func:`bn_gelu_apply_plain`); the kernel on
    CUDA."""
    noise = w is not None
    _check(x, _noise_maps(x, n_l, n_g) if noise else (),
           [("mean", mean), ("var", var), ("scale", scale), ("bias", bias), ("w", w)],
           cl if noise else None)
    if x.device.type == "cpu":
        return bn_gelu_apply_plain(x, mean, var, scale, bias, w, n_l, n_g, cl)
    b, c, hw = _geometry(x)
    out = torch.empty_like(x)
    vec, tile, group = apply_design(b, c, hw, x.element_size(), _aligned(x, out, n_l, n_g))
    _launch("ffc_bn_gelu_apply", x, _DTYPE_CODES[x.dtype], int(noise), x.data_ptr(),
            mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(w),
            _ptr(n_l), _ptr(n_g), out.data_ptr(), b, c, hw, cl if noise else c, int(vec),
            tile, group)
    _count(bn_gelu_apply, tuple(x.shape[1:]))
    return out


@_counted
def bn_bwd_reduce(x, g, mean, var, scale, bias, n_l=None, n_g=None, cl=None):
    """(S1, S2[, S3]) per channel, f32 (see :func:`bn_bwd_reduce_plain`);
    one launch of the reduce kernel on CUDA, as :func:`bwd_reduce_design`
    picks. Under a process group the sums are gathered from the processes
    in rank order and summed by ``fu_reduce``."""
    noise = n_l is not None
    _check(x, [("g", g, tuple(x.shape))] + (_noise_maps(x, n_l, n_g) if noise else []),
           [("mean", mean), ("var", var), ("scale", scale), ("bias", bias)],
           cl if noise else None)
    if x.device.type == "cpu":
        return bn_bwd_reduce_plain(x, g, mean, var, scale, bias, n_l, n_g, cl)
    b, c, hw = _geometry(x)
    vec, cluster = bwd_reduce_design(b, c, hw, x.element_size(), _aligned(x, g, n_l, n_g))
    out = x.new_empty((3 if noise else 2, c), dtype=torch.float32)
    _launch("ffc_bn_bwd_reduce", x, _DTYPE_CODES[x.dtype], int(noise), x.data_ptr(),
            g.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), _ptr(n_l), _ptr(n_g), cl if noise else c, out.data_ptr(), b, c,
            hw, int(vec), cluster)
    _count(bn_bwd_reduce, tuple(x.shape[1:]))
    if parallel.active():
        n = out.shape[0]
        out = _reduce(parallel.all_gather_rows(out.view(1, n * c))).view(n, c)
    return out.unbind()


@_counted
def bn_bwd_dx(x, g, mean, var, scale, bias, s1, s2, g_mean=None, g_var=None, w=None,
              cl=None):
    """dx, or (dx, dn_l, dn_g) with ``w`` (see :func:`bn_bwd_dx_plain`);
    one launch of the dx kernel on CUDA, as :func:`dx_design` picks. Under
    a process group s1 and s2 are the global batch's sums and the kernel
    takes the global count."""
    noise = w is not None
    _check(x, [("g", g, tuple(x.shape))],
           [("mean", mean), ("var", var), ("scale", scale), ("bias", bias), ("s1", s1),
            ("s2", s2), ("g_mean", g_mean), ("g_var", g_var), ("w", w)],
           cl if noise else None)
    if x.device.type == "cpu":
        return bn_bwd_dx_plain(x, g, mean, var, scale, bias, s1, s2, g_mean, g_var, w, cl)
    b, c, hw = _geometry(x)
    dx = torch.empty_like(x)
    dn_l = dn_g = None
    if noise:
        dn_l, dn_g = (x.new_empty((b, 1) + tuple(x.shape[2:])) for _ in range(2))
    vec, lanes, group, cluster = dx_design(b, c, hw, x.element_size(), _aligned(x, g, dx),
                                           noise)
    _launch("ffc_bn_bwd_dx", x, _DTYPE_CODES[x.dtype], int(noise), x.data_ptr(),
            g.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), s1.data_ptr(), s2.data_ptr(), _ptr(g_mean), _ptr(g_var),
            _ptr(w), dx.data_ptr(), _ptr(dn_l), _ptr(dn_g), b, c, hw, cl if noise else c,
            parallel.global_count(b * hw), int(vec), lanes, group, cluster)
    _count(bn_bwd_dx, tuple(x.shape[1:]))
    return (dx, dn_l, dn_g) if noise else dx


# --- the training op ----------------------------------------------------------------


class _PackedBnGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w, n_l, n_g, cl):
        mean, var = bn_stats(x)
        out = bn_gelu_apply(x, mean, var, scale, bias, w, n_l, n_g, cl)
        ctx.save_for_backward(x, scale, bias, w, n_l, n_g, mean, var)
        ctx.cl = cl
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        x, scale, bias, w, n_l, n_g, mean, var = ctx.saved_tensors
        g = torch.zeros_like(x) if g_out is None else g_out.contiguous()
        # every process's statistics are the global ones: their cotangents add up
        g_mean, g_var = (None if t is None else parallel.sum_over_processes(t)
                         for t in (g_mean, g_var))
        sums = bn_bwd_reduce(x, g, mean, var, scale, bias, n_l, n_g, ctx.cl)
        grads = bn_bwd_dx(x, g, mean, var, scale, bias, sums[0], sums[1], g_mean, g_var,
                          w, ctx.cl)
        # the sums are the global batch's: the parameters take this process's share
        share = [parallel.param_share(t) for t in sums]
        if w is None:
            return grads, share[1], share[0], None, None, None, None
        dx, dn_l, dn_g = grads
        return dx, share[1], share[0], share[2], dn_l, dn_g, None


def packed_bn_gelu(x, scale, bias):
    """Train-mode packed BN + tanh-GELU: ``(out, bmean, bvar)``,
    differentiable in x, scale and bias. Kernels on CUDA, plain versions
    on the CPU."""
    return _PackedBnGelu.apply(x.contiguous(), scale, bias, None, None, None, None)


def packed_bn_gelu_noise(x, scale, bias, w, n_l, n_g, cl):
    """:func:`packed_bn_gelu` with the noise fold, ``out = gelu(bn(x)) +
    w·(n_l below cl, n_g from cl on)``; differentiable in x, scale, bias,
    w, n_l and n_g."""
    return _PackedBnGelu.apply(x.contiguous(), scale, bias, w, n_l.contiguous(),
                               n_g.contiguous(), cl)
