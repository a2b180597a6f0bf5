"""Class-conditional GAN models, the JAX package's ``models/conditional.py``.

Generators take ``(z, compute_dtype, generator, y)``, discriminators
``(x, compute_dtype, y, generator)`` (and ``progress`` for
:class:`CondDCGANDiscriminator`), with labels ``y`` (B,) integers and
images NCHW; noise (NoiseInjection, input noise) is drawn from
``generator`` in training only.

- :class:`FFCCondGenerator`: a label embedding and z enter through two
  biased ConvT stems (1x1 -> 4x4, BN, exact GELU; ``stem="convt"``) or one
  dense layer on their concatenation (``stem="dense"``, computed in f32 as
  flax's Dense promotes to its parameters); then the FFC ladder of
  :class:`~.ffc_gan.FFCGenerator` with class-conditional BN (``cond_bn``),
  or in packed-branch mode from 128px where it is off.
- :class:`CondSNDiscriminator`: the SN conv ladder over the image and one
  label plane (a (num_classes, R²) table), optional input noise on the
  image.
- :class:`FFCCondDiscriminator`: input noise, labels modulo
  ``num_classes``, a label plane, four FFC_BN_ACT blocks with biased
  convolutions, class-conditional BN and LeakyReLU(0.1), an SN dense head.
- :class:`CondDCGANGenerator`, :class:`CondDCGANDiscriminator` and
  :class:`FFCCondDCGANDiscriminator`: the reference library's cDCGAN
  family (label and input stems, a log2 ladder, sigmoid heads; the
  discriminator's optional input noise ``0.1 * 0.01**progress``).

Every flatten before a dense head runs in (H, W, C) order, as the JAX
package flattens NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.ffc import FFC_BN_ACT, resize_output
from ..nn.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
    GaussianNoise,
    LabelEmbedding,
    SNConv2d,
    SNDense,
    reset_parameters,
)
from ..utils.policy import resolve_dtype
from .ffc_gan import D_LADDERS, PACKED_MIN_RES, add_ladder, run_ladder


def _labels(y: Optional[torch.Tensor]) -> torch.Tensor:
    if y is None:
        raise ValueError("a class-conditional model needs labels")
    return y.reshape(-1).long()


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    reset_parameters(model, torch.Generator().manual_seed(0) if generator is None else generator)


def draw_input_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) noise of x's shape, f32, on x's device, from ``generator``:
    :class:`CondDCGANDiscriminator`'s input noise before its scale."""
    return torch.randn(x.shape, generator=generator, device=x.device)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


PRESETS = {
    # the reference's cifar/svhn 32px script
    "cifar32": dict(stem="convt", cond_bn=True, mg=4, channel_mults=(4, 2, 1)),
    # its STL 48px script
    "stl48": dict(stem="dense", cond_bn=True, mg=6, channel_mults=(4, 2, 1)),
    # its 128px textures script
    "tex128": dict(stem="convt", cond_bn=False, mg=4, channel_mults=(4, 2, 1, 1, 1)),
    # the library path: no per-block norm, no conditional BN
    "library64": dict(stem="convt", cond_bn=False, mg=4, block_norm="identity",
                      channel_mults=(4, 2, 1, 1)),
}


class FFCCondGenerator(nn.Module):
    """Class-conditional FFC generator; output resolution ``mg * 2 **
    len(channel_mults)`` (the ConvT stem's map is 4x4, so mg is 4 there).
    ``cond_spectral_bn`` makes the blocks' FourierUnits class-conditional
    too (off by default, as in the JAX package)."""

    def __init__(
        self, z_size: int = 128, num_classes: int = 10, ngf: int = 64,
        ratio_g: float = 0.25, mg: int = 4, channel_mults: Sequence[int] = (4, 2, 1),
        out_channels: int = 3, stem: str = "convt", cond_bn: bool = True,
        block_norm: str = "batch", cond_spectral_bn: bool = False,
        packed: Optional[bool] = None, generator: Optional[torch.Generator] = None,
    ):
        """``packed``: packed-branch mode, taken only without conditional
        BN; None takes it from ``PACKED_MIN_RES`` px on."""
        super().__init__()
        if stem not in ("convt", "dense"):
            raise ValueError(f"stem must be 'convt' or 'dense', got {stem!r}")
        self.z_size, self.num_classes, self.mg, self.stem = z_size, num_classes, mg, stem
        self.channel_mults = tuple(channel_mults)
        nclass = num_classes if cond_bn else 0
        packed = self.resolution >= PACKED_MIN_RES if packed is None else packed
        self.packed = packed and nclass <= 1
        self.label_classes = nclass
        self.label_embed = LabelEmbedding(num_classes, num_classes)
        if stem == "convt":
            self.label_conv = ConvTranspose2d(num_classes, ngf * 4, 4, bias=True)
            self.label_bn = BatchNorm(ngf * 4)
            self.input_conv = ConvTranspose2d(z_size, ngf * 4, 4, bias=True)
            self.input_bn = BatchNorm(ngf * 4)
        else:
            self.noise_to_feature = Dense(z_size + num_classes, mg * mg * ngf * 8)
        add_ladder(self, ngf * 8, ngf, ratio_g, self.channel_mults, out_channels, self.packed,
                   norm=block_norm, num_classes=nclass, cond_spectral_bn=cond_spectral_bn)
        _init(self, generator)

    @property
    def resolution(self) -> int:
        return self.mg * 2 ** len(self.channel_mults)

    @staticmethod
    def for_preset(preset: str, **kw) -> "FFCCondGenerator":
        """``PRESETS[preset]`` (cifar32, stl48, tex128, library64) with
        ``kw`` over it."""
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        return FFCCondGenerator(**{**PRESETS[preset], **kw})

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, z_size) latents and (B,) labels -> (B, C, R, R) images in
        ``compute_dtype``; in training ``generator`` draws the noise."""
        if self.training and generator is None:
            raise ValueError("a training forward needs a noise generator")
        dt = resolve_dtype(compute_dtype)
        y = _labels(y)
        b = z.shape[0]
        embedding = self.label_embed(y)
        if self.stem == "convt":
            lbl = self.label_bn(self.label_conv(embedding.to(dt).view(b, -1, 1, 1)))
            inp = self.input_bn(self.input_conv(z.to(dt).view(b, -1, 1, 1)))
            x = torch.cat([F.gelu(inp), F.gelu(lbl)], dim=1)
        else:
            stem = self.noise_to_feature(torch.cat([z.float(), embedding], dim=1))
            # laid out NHWC, as in the JAX package
            x = stem.view(b, self.mg, self.mg, -1).permute(0, 3, 1, 2).contiguous().to(dt)
        return run_ladder(self, x, len(self.channel_mults), generator,
                          y if self.label_classes > 1 else None)


class CondSNDiscriminator(nn.Module):
    """The SN conv ladder of :class:`~.ffc_gan.SNConvDiscriminator` over
    the image and a label plane (4 channels); 48 and 96 px take the 32 and
    64 px ladders. With ``use_noise`` the image gets N(0, noise_stddev²)
    noise in training, before the plane joins it. Returns (B, 1) logits."""

    def __init__(self, num_classes: int = 10, resolution: int = 32, use_noise: bool = False,
                 noise_stddev: float = 0.05, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        base = {48: 32, 96: 64}.get(resolution, resolution)
        if base not in D_LADDERS:
            raise ValueError(f"no discriminator ladder for {resolution}px; have "
                             f"{sorted(D_LADDERS)} and 48, 96")
        self.ladder = D_LADDERS[base]
        self.noise = GaussianNoise(noise_stddev) if use_noise else None
        self.label_embed = LabelEmbedding(num_classes, resolution * resolution)
        cin = in_channels + 1
        for i, (feat, k, s) in enumerate(self.ladder):
            self.add_module(f"conv{i}", SNConv2d(cin, feat, k, stride=s, padding=1))
            cin = feat
        head = resolution >> sum(s == 2 for _, _, s in self.ladder)
        self.fc = SNDense(head * head * cin, 1)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = resolve_dtype(compute_dtype)
        b, _, h, w = x.shape
        x = x.to(dt)
        if self.noise is not None:
            x = self.noise(x, generator)
        plane = self.label_embed(_labels(y)).view(b, 1, h, w).to(dt)
        x = torch.cat([x, plane], dim=1)
        for i in range(len(self.ladder)):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), negative_slope=0.1)
        return self.fc(_flatten_hwc(x))


class FFCCondDiscriminator(nn.Module):
    """All-FFC class-conditional discriminator: input noise
    (``noise_stddev``, training only), labels modulo ``num_classes``, a
    label plane, four FFC_BN_ACT blocks (out 64/128/256/512, kernels 3/4/4/4,
    strides 1/2/2/2, global ratios 0→g, g→g, g→g, g→0) with biased
    convolutions, class-conditional BN and LeakyReLU(0.1), and an SN dense
    head. At 32px and ratio 0.25 its FourierUnits run on (B, 16, 16, 16)
    and (B, 32, 8, 8). Returns (B, 1) logits."""

    def __init__(self, num_classes: int = 10, ratio_g: float = 0.25, noise_stddev: float = 0.05,
                 cond_spectral_bn: bool = False, resolution: int = 32, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.noise = GaussianNoise(noise_stddev)
        self.label_embed = LabelEmbedding(num_classes, resolution * resolution)
        specs = ((64, 3, 1, 0.0, ratio_g), (128, 4, 2, ratio_g, ratio_g),
                 (256, 4, 2, ratio_g, ratio_g), (512, 4, 2, ratio_g, 0.0))
        self.n_blocks = len(specs)
        cin = in_channels + 1
        for i, (cout, k, s, gin, gout) in enumerate(specs):
            self.add_module(f"block{i}", FFC_BN_ACT(
                cin, cout, k, gin, gout, stride=s, padding=1, use_bias=True, norm="batch",
                activation="leaky_relu", num_classes=num_classes,
                cond_spectral_bn=cond_spectral_bn,
            ))
            cin = cout
        head = resolution // 8
        self.fc = SNDense(head * head * cin, 1)
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = resolve_dtype(compute_dtype)
        b, _, h, w = x.shape
        x = self.noise(x.to(dt), generator)
        y = _labels(y) % self.num_classes
        plane = self.label_embed(y).view(b, 1, h, w).to(dt)
        feat = (torch.cat([x, plane], dim=1), None)
        for i in range(self.n_blocks):
            feat = getattr(self, f"block{i}")(feat, y)
        return self.fc(_flatten_hwc(resize_output(feat)))


class CondDCGANGenerator(nn.Module):
    """The reference library's cDCGAN generator: label and noise ConvT
    stems (1x1 -> 4x4, biased, BN, LeakyReLU 0.2), ``log2(ngf) - 3``
    ConvT up-blocks (BN, ReLU), a ConvT to ``nc`` channels and tanh; the
    output is ngf x ngf. It draws no noise."""

    def __init__(self, nz: int = 100, nc: int = 3, ngf: int = 64, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size = nz
        self.number_convs = int(math.log2(ngf)) - 3
        mult = 2 ** (self.number_convs - 1)
        self.label_embed = LabelEmbedding(num_classes, num_classes)
        self.label_conv = ConvTranspose2d(num_classes, ngf * mult, 4, bias=True)
        self.label_bn = BatchNorm(ngf * mult)
        self.input_conv = ConvTranspose2d(nz, ngf * mult, 4, bias=True)
        self.input_bn = BatchNorm(ngf * mult)
        cin = 2 * ngf * mult
        for itr in range(self.number_convs, 0, -1):
            cout = ngf * 2 ** itr // 2
            self.add_module(f"convt{itr}", ConvTranspose2d(cin, cout, 4, stride=2, padding=1))
            self.add_module(f"bn{itr}", BatchNorm(cout))
            cin = cout
        self.to_rgb = ConvTranspose2d(cin, nc, 4, stride=2, padding=1)
        _init(self, generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = resolve_dtype(compute_dtype)
        b = z.shape[0]
        lbl = self.label_conv(self.label_embed(_labels(y)).to(dt).view(b, -1, 1, 1))
        inp = self.input_conv(z.to(dt).view(b, -1, 1, 1))
        x = torch.cat([F.leaky_relu(self.input_bn(inp), 0.2),
                       F.leaky_relu(self.label_bn(lbl), 0.2)], dim=1)
        for itr in range(self.number_convs, 0, -1):
            x = torch.relu(getattr(self, f"bn{itr}")(getattr(self, f"convt{itr}")(x)))
        return torch.tanh(self.to_rgb(x))


def _label_stem(model: nn.Module, y: torch.Tensor, b: int, dt: torch.dtype) -> torch.Tensor:
    """The cDCGAN discriminators' label plane (B, 1, ndf, ndf) through
    ``label_conv`` (k4 s2 p1, biased)."""
    plane = model.label_embed(y).view(b, 1, model.ndf, model.ndf).to(dt)
    return model.label_conv(plane)


class CondDCGANDiscriminator(nn.Module):
    """The reference library's conditional discriminator on ndf x ndf
    images: a label plane and the image each through a k4 s2 conv and
    LeakyReLU(0.2), concatenated; ``log2(ndf) - 3`` doubling k4 s2 convs
    (BN, or spectral norm without bias or BN with ``use_sn``), LeakyReLU
    0.2; a k4 head and sigmoid. With ``use_noise`` the image gets noise of
    scale ``0.1 * 0.01**progress`` in training (``progress``, the share of
    training done, 0 unless given). Returns (B, 1) probabilities."""

    def __init__(self, nc: int = 3, ndf: int = 64, num_classes: int = 10,
                 use_sn: bool = False, use_noise: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ndf, self.use_sn, self.use_noise = ndf, use_sn, use_noise
        self.number_convs = int(math.log2(ndf)) - 2
        self.label_embed = LabelEmbedding(num_classes, ndf * ndf)
        self.label_conv = Conv2d(1, ndf, 4, stride=2, padding=1, bias=True)
        self.input_conv = Conv2d(nc, ndf, 4, stride=2, padding=1)
        cin = 2 * ndf
        for itr in range(1, self.number_convs):
            cout = ndf * 2 ** itr * 2
            if use_sn:
                self.add_module(f"conv{itr}", SNConv2d(cin, cout, 4, stride=2, padding=1,
                                                       bias=False))
            else:
                self.add_module(f"conv{itr}", Conv2d(cin, cout, 4, stride=2, padding=1))
                self.add_module(f"bn{itr}", BatchNorm(cout))
            cin = cout
        self.head = (SNConv2d(cin, 1, 4, bias=False) if use_sn else Conv2d(cin, 1, 4))
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                progress=0.0) -> torch.Tensor:
        dt = resolve_dtype(compute_dtype)
        b = x.shape[0]
        plane = F.leaky_relu(_label_stem(self, _labels(y), b, dt), 0.2)
        if self.use_noise and self.training:
            if generator is None:
                raise ValueError("a training forward with input noise needs a noise generator")
            # progress: a device tensor under the trainer, so a replayed
            # step reads the count it advanced
            scale = 0.1 * (torch.pow(0.01, progress) if torch.is_tensor(progress)
                           else 0.01 ** progress)
            x = x.float() + scale * draw_input_noise(x, generator)
        x = F.leaky_relu(self.input_conv(x.to(dt)), 0.2)
        x = torch.cat([x, plane], dim=1)
        for itr in range(1, self.number_convs):
            x = getattr(self, f"conv{itr}")(x)
            if not self.use_sn:
                x = getattr(self, f"bn{itr}")(x)
            x = F.leaky_relu(x, 0.2)
        return torch.sigmoid(self.head(x).reshape(b, 1))


class FFCCondDCGANDiscriminator(nn.Module):
    """The reference library's all-FFC conditional discriminator on ndf x
    ndf images: a label plane and the image each through a k4 s2 conv and
    exact GELU (the image after input noise N(0, 0.05²) in training with
    ``use_noise``), concatenated; ``log2(ndf) - 3`` FFC_BN_ACT blocks (k4
    s2, global ratio 0→0.5 then 0.5, no norm, GELU); an FFC_BN_ACT head (k4
    s1 p0, 0.5→0, sigmoid). Returns (B, 1) probabilities. Labels are taken
    modulo ``num_classes``."""

    def __init__(self, nc: int = 3, ndf: int = 64, num_classes: int = 10,
                 use_sn: bool = False, use_noise: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_sn:
            raise NotImplementedError(
                "use_sn is not ported yet: it waits for spectral norm inside the FFC "
                "layers (ROADMAP.md, queue 1 item 4)")
        self.ndf, self.num_classes = ndf, num_classes
        self.number_convs = int(math.log2(ndf)) - 2
        self.noise = GaussianNoise(0.05) if use_noise else None
        self.label_embed = LabelEmbedding(num_classes, ndf * ndf)
        self.label_conv = Conv2d(1, ndf, 4, stride=2, padding=1, bias=True)
        self.input_conv = Conv2d(nc, ndf, 4, stride=2, padding=1)
        cin = 2 * ndf
        for itr in range(1, self.number_convs):
            cout = ndf * 2 ** itr * 2
            self.add_module(f"block{itr}", FFC_BN_ACT(
                cin, cout, 4, 0.0 if itr == 1 else 0.5, 0.5, stride=2, padding=1,
                norm="identity", activation="gelu",
            ))
            cin = cout
        self.head = FFC_BN_ACT(cin, 1, 4, 0.5, 0.0, stride=1, padding=0, norm="identity",
                               activation="sigmoid")
        _init(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = resolve_dtype(compute_dtype)
        b = x.shape[0]
        plane = F.gelu(_label_stem(self, _labels(y) % self.num_classes, b, dt))
        x = x.to(dt)
        if self.noise is not None:
            x = self.noise(x, generator)
        feat = (torch.cat([F.gelu(self.input_conv(x)), plane], dim=1), None)
        for itr in range(1, self.number_convs):
            feat = getattr(self, f"block{itr}")(feat)
        return resize_output(self.head(feat)).reshape(b, 1)
