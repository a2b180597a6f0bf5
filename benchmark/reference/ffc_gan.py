"""Plain PyTorch reference of the FFC-GAN pair: the FFC generator and the
spectral-normed conv discriminator, as functions of a flat dict of f32
tensors keyed by the parameter and buffer names of the measured models.

Written from the FFC-GAN scripts (``fgan_complete.py``,
``fgan128_complete.py``) and the FFC paper (Chi et al., NeurIPS 2020),
imports nothing but torch:

- generator: Dense(z -> mg*mg*ngf*8) laid out (mg, mg, C), then per
  channel multiple an FFC block (k4 s2 p1 transposed convolutions on the
  l2l, l2g and g2l branches; on g2g a spectral transform: nearest x2
  upsample, squeeze-and-excite gate, 1x1 conv, BN, ReLU, x + FourierUnit,
  1x1 conv), BN per branch, tanh-form GELU, noise injection per branch in
  training, then a k3 s1 p1 FFC to the image channels with tanh;
- FourierUnit: orthonormal real 2-D DFT, [re | im] channels, a (2C, 2C)
  mix, BN over (B, H, W/2+1), ReLU, and the inverse Re(eh R fw^T) with the
  half-spectrum weights (1 at DC and Nyquist, 2 elsewhere), as products
  with DFT matrices;
- BN: biased batch variance in training, running statistics updated as
  0.9 old + 0.1 batch; eps 1e-5;
- discriminator: spectral-normed convolutions with LeakyReLU(0.1), one
  power iteration per training forward, the (H, W, C)-ordered features to
  a spectral-normed dense head.

Every operand is f32. ``Precision`` rounds every activation a model
computed in a lower precision would hold (the operands and results of the
products: convolutions, dense layers, the mix and the transforms' factor
products; the outputs of BN, activations, noise and residual adds) and
their cotangents: the control that a comparison has to reject. BN
statistics and the losses stay f32, as the measured program keeps them.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
SN_EPS = 1e-12

# (features, kernel, stride) of the discriminator's convolutions, padding 1
D_LADDERS = {
    32: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
         (256, 4, 2), (512, 3, 1)),
    128: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
          (256, 4, 2), (512, 3, 1), (512, 4, 2), (512, 4, 2)),
}

Tensors = Dict[str, torch.Tensor]


class Precision:
    """Rounding of the products' operands. ``None``: f32, no rounding.
    ``"fp8"``: each operand scaled by its largest magnitude onto float8
    e4m3 and back, its cotangent likewise onto float8 e5m2 (per-tensor
    scaling, as fp8 training does). ``"bf16"``: each operand and its
    cotangent rounded to bfloat16 (a computation in the configuration's
    own precision, independent of the measured program)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return t
        return (_Fp8 if self.kind == "fp8" else _Bf16).apply(t)


def _round_scaled(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_scaled(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, 57344.0)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


F32 = Precision()


class f32_products:
    """Within the block f32 products on the card run in f32: TF32 off for
    matmuls and for cuDNN's convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def split_channels(channels: int, ratio: float) -> Tuple[int, int]:
    """(local, global) channel counts, c_g = int(c * ratio)."""
    c_g = int(channels * ratio)
    return channels - c_g, c_g


# --- the leaves: names, shapes and how each is first drawn ----------------------
#
# init kinds: "conv" N(0, 0.02); "bn" N(1, 0.02); "zero"; "one"; "dense"
# U(+-sqrt(1/fan_in)); "noise" N(0, noise_std); "unit" a unit-norm N(0, 1)
# vector. Buffers are the BN running statistics and the spectral-norm u.


def _ffc_leaves(p: str, cin: int, cout: int, k: int, gin: float, gout: float,
                transpose: bool) -> Iterator[tuple]:
    (in_cl, in_cg), (out_cl, out_cg) = split_channels(cin, gin), split_channels(cout, gout)
    for name, a, b in (("convl2l", in_cl, out_cl), ("convl2g", in_cl, out_cg),
                       ("convg2l", in_cg, out_cl)):
        if a and b:
            yield f"{p}.{name}.weight", (a, b, k, k) if transpose else (b, a, k, k), "conv"
    if in_cg and out_cg:
        s, half = f"{p}.convg2g", out_cg // 2
        hidden = max(in_cg // 16, 1)
        yield f"{s}.se.fc1.weight", (hidden, in_cg), "dense"
        yield f"{s}.se.fc2.weight", (in_cg, hidden), "dense"
        yield f"{s}.conv1.weight", (half, in_cg, 1, 1), "conv"
        yield from _bn_leaves(f"{s}.bn", half)
        yield f"{s}.fu.mix_kernel", (2 * half, 2 * half), "conv"
        yield f"{s}.fu.bn_scale", (2 * half,), "bn"
        yield f"{s}.fu.bn_bias", (2 * half,), "zero"
        yield f"{s}.fu.running_mean", (2 * half,), "zero"
        yield f"{s}.fu.running_var", (2 * half,), "one"
        yield f"{s}.conv2.weight", (out_cg, half, 1, 1), "conv"


def _bn_leaves(p: str, c: int) -> Iterator[tuple]:
    yield f"{p}.weight", (c,), "bn"
    yield f"{p}.bias", (c,), "zero"
    yield f"{p}.running_mean", (c,), "zero"
    yield f"{p}.running_var", (c,), "one"


def generator_leaves(cfg: dict) -> Iterator[tuple]:
    """(name, shape, init) of every parameter and buffer of the generator,
    in the measured model's module order."""
    ngf, mg, ratio = cfg["ngf"], cfg["mg"], cfg["ratio_g"]
    yield "noise_to_feature.weight", (mg * mg * ngf * 8, cfg["z_size"]), "dense"
    yield "noise_to_feature.bias", (mg * mg * ngf * 8,), "zero"
    cin, gin = ngf * 8, 0.0
    for i, mult in enumerate(cfg["channel_mults"]):
        cout = ngf * mult
        yield from _ffc_leaves(f"block{i}.ffc", cin, cout, 4, gin, ratio, True)
        out_cl, out_cg = split_channels(cout, ratio)
        yield from _bn_leaves(f"block{i}.bn_l", out_cl)
        if out_cg:
            yield from _bn_leaves(f"block{i}.bn_g", out_cg)
        yield f"lcl_noise{i}.weight", (out_cl,), "noise"
        if out_cg:
            yield f"glb_noise{i}.weight", (out_cg,), "noise"
        cin, gin = cout, ratio
    yield from _ffc_leaves("to_rgb.ffc", cin, cfg["out_channels"], 3, gin, 0.0, False)


def discriminator_leaves(cfg: dict) -> Iterator[tuple]:
    """(name, shape, init) of every parameter and buffer of the SN conv
    discriminator."""
    cin = cfg["out_channels"]
    for i, (feat, k, _) in enumerate(D_LADDERS[cfg["resolution"]]):
        yield f"conv{i}.weight", (feat, cin, k, k), "conv"
        yield f"conv{i}.bias", (feat,), "zero"
        yield f"conv{i}.u", (feat,), "unit"
        cin = feat
    yield "fc.weight", (1, cfg["mg"] ** 2 * cin), "dense"
    yield "fc.bias", (1,), "zero"
    yield "fc.u", (1,), "unit"


BUFFER_SUFFIXES = ("running_mean", "running_var", ".u")


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


def make_leaves(leaves, generator: torch.Generator, device, noise_std: float) -> Tensors:
    """Every leaf drawn from ``generator`` in two large calls (one of
    normals, one of uniforms) on ``device``, f32, then cut and scaled."""
    leaves = list(leaves)
    count = lambda kinds: sum(math.prod(s) for _, s, k in leaves if k in kinds)
    normals = torch.randn(count(("conv", "bn", "noise", "unit")), generator=generator,
                          device=device)
    uniforms = torch.rand(count(("dense",)), generator=generator, device=device)
    out, at_n, at_u = {}, 0, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        if kind in ("zero", "one"):
            out[name] = torch.full(shape, float(kind == "one"), device=device)
            continue
        if kind == "dense":
            bound = math.sqrt(1.0 / shape[1])
            out[name] = (uniforms[at_u:at_u + n].view(shape) * 2 - 1) * bound
            at_u += n
            continue
        v = normals[at_n:at_n + n].view(shape)
        at_n += n
        if kind == "conv":
            out[name] = v * 0.02
        elif kind == "bn":
            out[name] = 1.0 + v * 0.02
        elif kind == "noise":
            out[name] = v * noise_std
        else:  # unit
            out[name] = v / (torch.linalg.vector_norm(v) + SN_EPS)
    return out


# --- the DFT as products ---------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _dft_mats(h: int, w: int) -> Tuple[torch.Tensor, ...]:
    """f64 (ah, bh, cw, dw, eh_r, eh_i, fw_r, fw_i) on the CPU: the
    orthonormal forward rDFT (H axis complex, W axis to W/2+1 columns)
    and the inverse Re(eh R fw^T) with fw weighted by the half-spectrum
    duplication c."""
    wf = w // 2 + 1
    u = torch.arange(h, dtype=torch.float64)
    ang_h = 2 * math.pi * torch.remainder(u[:, None] * u[None, :], h) / h
    scale = 1.0 / math.sqrt(h * w)
    q = torch.arange(w, dtype=torch.float64)[:, None]
    v = torch.arange(wf, dtype=torch.float64)[None, :]
    ang_w = 2 * math.pi * torch.remainder(q * v, w) / w
    c = torch.full((wf,), 2.0, dtype=torch.float64)
    c[0] = 1.0
    if w % 2 == 0:
        c[-1] = 1.0
    return (torch.cos(ang_h) * scale, -torch.sin(ang_h) * scale, torch.cos(ang_w),
            -torch.sin(ang_w), torch.cos(ang_h) * scale, torch.sin(ang_h) * scale,
            torch.cos(ang_w) * c, torch.sin(ang_w) * c)


def _mats(h: int, w: int, device) -> Tuple[torch.Tensor, ...]:
    return tuple(m.to(device=device, dtype=torch.float32) for m in _dft_mats(h, w))


def rfft2(x: torch.Tensor, q: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    ah, bh, cw, dw = _mats(x.shape[-2], x.shape[-1], x.device)[:4]
    x = q(x)
    t_r, t_i = q(x @ cw), q(x @ dw)
    return q(ah @ t_r - bh @ t_i), q(ah @ t_i + bh @ t_r)


def irfft2(f_r: torch.Tensor, f_i: torch.Tensor, s: Tuple[int, int], q: Precision):
    eh_r, eh_i, fw_r, fw_i = _mats(*s, f_r.device)[4:]
    f_r, f_i = q(f_r), q(f_i)
    p_r, p_i = q(eh_r @ f_r - eh_i @ f_i), q(eh_r @ f_i + eh_i @ f_r)
    return q(p_r @ fw_r.T - p_i @ fw_i.T)


# --- layers -------------------------------------------------------------------


class Model:
    """A pass over one model's tensors ``t`` (parameters and buffers by
    name). ``train``: batch statistics, whose running ones are updated in
    ``t``, and the spectral norm's power iteration, whose u is updated in
    ``t``; eval reads them."""

    def __init__(self, t: Tensors, train: bool, q: Precision = F32,
                 stub_fourier_units: bool = False, momentum: float = BN_MOMENTUM):
        self.t, self.train, self.q = t, train, q
        self.stub_fourier_units, self.momentum = stub_fourier_units, momentum

    def batch_norm(self, p: str, x: torch.Tensor, mean=None, var=None) -> torch.Tensor:
        t = self.t
        if self.train:
            if mean is None:
                mean = x.mean(dim=(0, 2, 3))
                var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            with torch.no_grad():
                for k, v in (("running_mean", mean), ("running_var", var)):
                    t[f"{p}.{k}"].mul_(self.momentum).add_(v.detach(), alpha=1 - self.momentum)
        else:
            mean, var = t[f"{p}.running_mean"], t[f"{p}.running_var"]
        return (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]

    def bn(self, p: str, x: torch.Tensor) -> torch.Tensor:
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            x_hat = self.batch_norm(p, x, mean, var)
        else:
            x_hat = self.batch_norm(p, x)
        return self.q(x_hat * self.t[f"{p}.weight"][:, None, None]
                      + self.t[f"{p}.bias"][:, None, None])

    def linear(self, p: str, x: torch.Tensor, bias: bool) -> torch.Tensor:
        y = self.q(F.linear(self.q(x), self.q(self.t[f"{p}.weight"])))
        return self.q(y + self.t[f"{p}.bias"]) if bias else y

    def conv(self, w: torch.Tensor, x: torch.Tensor, transpose: bool, **kw) -> torch.Tensor:
        fn = F.conv_transpose2d if transpose else F.conv2d
        return self.q(fn(self.q(x), self.q(w), **kw))

    def fourier_unit(self, p: str, x: torch.Tensor) -> torch.Tensor:
        t, (c, h, w) = self.t, x.shape[1:]
        if self.stub_fourier_units:
            return torch.zeros_like(x)
        f_r, f_i = rfft2(x, self.q)
        z = torch.cat([f_r, f_i], dim=1)
        m = self.q(torch.einsum("bjuv,jd->bduv", self.q(z), self.q(t[f"{p}.mix_kernel"])))
        pre = (self.batch_norm(p, m) * t[f"{p}.bn_scale"][:, None, None]
               + t[f"{p}.bn_bias"][:, None, None])
        r = torch.relu(pre)
        return irfft2(r[:, :c], r[:, c:], (h, w), self.q)

    def spectral_transform(self, p: str, x: torch.Tensor, upsample: bool) -> torch.Tensor:
        if upsample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        gate = x.mean(dim=(2, 3))
        gate = torch.sigmoid(self.linear(f"{p}.se.fc2", torch.relu(
            self.linear(f"{p}.se.fc1", gate, False)), False))
        x = self.q(x * gate[:, :, None, None])
        x = torch.relu(self.bn(f"{p}.bn", self.conv(self.t[f"{p}.conv1.weight"], x, False)))
        return self.conv(self.t[f"{p}.conv2.weight"],
                         self.q(x + self.fourier_unit(f"{p}.fu", x)), False)

    def ffc(self, p: str, x_l, x_g, transpose: bool, **kw):
        t = self.t

        def branch(name, x):
            w = t.get(f"{p}.{name}.weight")
            return None if w is None or x is None else self.conv(w, x, transpose, **kw)

        def add(a, b):
            return b if a is None else a if b is None else self.q(a + b)

        out_l = add(branch("convl2l", x_l), branch("convg2l", x_g))
        g2g = (self.spectral_transform(f"{p}.convg2g", x_g, transpose)
               if f"{p}.convg2g.conv1.weight" in t and x_g is not None else None)
        out_g = add(branch("convl2g", x_l), g2g)
        return out_l, out_g

    def spectral_norm(self, p: str) -> torch.Tensor:
        """The weight over sigma; in training one power iteration from the
        stored u, the new u stored."""
        t = self.t
        w = t[f"{p}.weight"]
        w_mat = w.reshape(w.shape[0], -1)
        u = t[f"{p}.u"]
        with torch.no_grad():
            v = l2_normalize(w_mat.detach().T @ u)
            if self.train:
                u = l2_normalize(w_mat.detach() @ v)
                t[f"{p}.u"].copy_(u)
        return w / (u @ (w_mat @ v))


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, which the configurations' bf16 training and
    serving state."""
    return F.gelu(x, approximate="tanh")


NoiseDraw = Callable[[Tuple[int, ...]], torch.Tensor]


def generator_forward(t: Tensors, cfg: dict, z: torch.Tensor, train: bool,
                      noise: Optional[NoiseDraw] = None, q: Precision = F32,
                      stub_fourier_units: bool = False,
                      momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """(B, z_size) -> (B, C, R, R) images in [-1, 1]. In training each
    block's two branches get ``w * n`` with n (B, 1, H, W) from ``noise``,
    the local branch's drawn first. ``stub_fourier_units``: every
    FourierUnit returns zeros, computing nothing (to count the rest's
    products). ``momentum``: the running statistics' weight of the old
    value in training (0 sets them to the batch's)."""
    m = Model(t, train, q, stub_fourier_units, momentum)
    b, mg, ratio = z.shape[0], cfg["mg"], cfg["ratio_g"]
    x = m.linear("noise_to_feature", z, True).view(b, mg, mg, -1).permute(0, 3, 1, 2)
    x_l, x_g = x, None
    for i in range(len(cfg["channel_mults"])):
        x_l, x_g = m.ffc(f"block{i}.ffc", x_l, x_g, True, stride=2, padding=1)
        x_l = q(gelu(m.bn(f"block{i}.bn_l", x_l)))
        x_g = None if x_g is None else q(gelu(m.bn(f"block{i}.bn_g", x_g)))
        if train:
            h, w = x_l.shape[2:]
            x_l = q(x_l + t[f"lcl_noise{i}.weight"][:, None, None] * noise((b, 1, h, w)))
            if x_g is not None:
                x_g = q(x_g + t[f"glb_noise{i}.weight"][:, None, None] * noise((b, 1, h, w)))
    out_l, _ = m.ffc("to_rgb.ffc", x_l, x_g, False, stride=1, padding=1)
    return q(torch.tanh(out_l))


def discriminator_forward(t: Tensors, cfg: dict, x: torch.Tensor, train: bool = True,
                          q: Precision = F32) -> torch.Tensor:
    """(B, C, R, R) images -> (B, 1) logits."""
    m = Model(t, train, q)
    for i, (_, _, s) in enumerate(D_LADDERS[cfg["resolution"]]):
        w = m.spectral_norm(f"conv{i}")
        x = q(m.conv(w, x, False, stride=s, padding=1) + t[f"conv{i}.bias"][:, None, None])
        x = q(F.leaky_relu(x, negative_slope=0.1))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return q(F.linear(q(x), q(m.spectral_norm("fc"))) + t["fc.bias"])


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255] uint8, truncating like a cast."""
    return (255.0 * (x.clamp(-1.0, 1.0) * 0.5 + 0.5)).to(torch.uint8)
