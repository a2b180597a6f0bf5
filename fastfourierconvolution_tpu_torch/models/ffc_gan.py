"""FFC-GAN generator (unconditional), the spectral-normed conv
discriminator, and the uint8 contract.

Generator: z -> Dense(mg*mg*ngf*8) -> (B, mg, mg, ngf*8) -> NCHW ->
[FFC_BN_ACT(k4 s2 p1, BN, GELU, upsampling) -> NoiseInjection on both
branches (training only)] x N -> FFC_BN_ACT(ngf -> out_ch, k3 s1 p1, tanh,
no norm) -> concat branches.

At 128px and above the generator runs in packed-branch mode by default
(``nn/ffc.py``; the JAX package's ``_PACKED_MIN_RES``). There each
block's noise injection is folded into its norm-act pass: the block gets
``(w, n_l, n_g)``, the two branches' weights concatenated local first and
their noise maps, drawn in the tuple path's order (per block n_l, then
n_g, each (B, 1, H, W)), so a packed and a tuple generator given the same
noise generator compute the same function.

Discriminators: [SNConv2d(k, s, p1) -> LeakyReLU(0.1)] per ladder entry ->
flatten in (H, W, C) order, as the JAX package flattens NHWC -> SNDense(1);
without spectral norm, Conv2d with a bias and Dense. The all-FFC
discriminator of the ``sngan`` preset: four FFC_BN_ACT blocks with biased
convolutions and LeakyReLU(0.1) -> concat branches -> flatten (H, W, C) ->
SNDense(1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.ffc import FFC_BN_ACT, Packed, resize_output, split_channels
from ..nn.layers import (
    Conv2d,
    Dense,
    NoiseInjection,
    SNConv2d,
    SNDense,
    draw_noise,
    reset_parameters,
)
from ..utils.policy import resolve_dtype

PRESETS = {
    32: dict(ngf=64, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1)),
    48: dict(ngf=64, ratio_g=0.25, mg=6, channel_mults=(4, 2, 1)),
    64: dict(ngf=64, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1, 1)),
    96: dict(ngf=64, ratio_g=0.25, mg=6, channel_mults=(4, 2, 1, 1)),
    128: dict(ngf=128, ratio_g=0.5, mg=4, channel_mults=(4, 2, 1, 1, 1)),
    256: dict(ngf=128, ratio_g=0.5, mg=4, channel_mults=(4, 2, 1, 1, 1, 1)),
}
# Packed-branch mode is the default from this resolution on.
PACKED_MIN_RES = 128


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> [0, 255] uint8, truncating like a cast."""
    return (255.0 * (x.clamp(-1.0, 1.0) * 0.5 + 0.5)).to(torch.uint8)


def draw_noise_fold(model: nn.Module, i: int, probe: torch.Tensor,
                    generator: torch.Generator):
    """Block ``i``'s noise-fold triple ``(w, n_l, n_g)``: the
    ``lcl_noise{i}``/``glb_noise{i}`` weights concatenated local first, and
    their noise maps drawn like the tuple path's (n_l, then n_g). ``probe``
    (B, ·, H, W) gives the block output's shape, dtype and device."""
    w = getattr(model, f"lcl_noise{i}").weight
    n_l = draw_noise(probe, generator)
    glb = getattr(model, f"glb_noise{i}", None)
    if glb is None:
        return w, n_l, n_l
    return torch.cat([w, glb.weight]), n_l, draw_noise(probe, generator)


def add_ladder(model: nn.Module, in_ch: int, ngf: int, ratio_g: float,
               channel_mults: Sequence[int], out_channels: int, packed: bool,
               norm: str = "batch", num_classes: int = 0,
               cond_spectral_bn: bool = False) -> None:
    """Adds a generator's up-blocks to ``model``: per block ``block{i}``
    (FFC_BN_ACT k4 s2 p1, ``norm``, GELU, upsampling; ``ngf * mults[i-1]``
    channels in, ``in_ch`` for the first, all-local, ``ngf * mults[i]``
    out), then ``lcl_noise{i}`` and, with global channels, ``glb_noise{i}``;
    then ``to_rgb`` (k3 s1 p1 to ``out_channels``, tanh, no norm)."""
    in_ratio = 0.0  # the stem output is all-local
    for i, mult in enumerate(channel_mults):
        out_ch = ngf * mult
        model.add_module(f"block{i}", FFC_BN_ACT(
            in_ch, out_ch, 4, in_ratio, ratio_g, stride=2, padding=1, norm=norm,
            activation="gelu", upsampling=True, packed=packed, num_classes=num_classes,
            cond_spectral_bn=cond_spectral_bn,
        ))
        out_cl, out_cg = split_channels(out_ch, ratio_g)
        model.add_module(f"lcl_noise{i}", NoiseInjection(out_cl))
        if out_cg > 0:
            model.add_module(f"glb_noise{i}", NoiseInjection(out_cg))
        in_ch, in_ratio = out_ch, ratio_g
    model.to_rgb = FFC_BN_ACT(
        in_ch, out_channels, 3, ratio_g, 0.0, stride=1, padding=1,
        norm="identity", activation="tanh", packed=packed,
    )


def run_ladder(model: nn.Module, x: torch.Tensor, n_blocks: int,
               generator: Optional[torch.Generator], y: Optional[torch.Tensor] = None):
    """The ladder that :func:`add_ladder` built, from the stem map ``x``
    (B, C, S, S) in the compute dtype: each block (given the labels ``y``
    on the tuple path) and, in training, its noise injection with noise
    from ``generator`` (folded into a packed block's norm-act pass), then
    ``to_rgb``; returns the images (B, C, R, R)."""
    b, s = x.shape[0], x.shape[2]
    if model.packed:
        feat = Packed(x, x.shape[1])
        for i in range(n_blocks):
            fold = None
            if model.training:
                hw = s * 2 ** (i + 1)
                fold = draw_noise_fold(model, i, x.new_empty((b, 1, hw, hw)), generator)
            feat = getattr(model, f"block{i}")(feat, noise_fold=fold)
        return resize_output(model.to_rgb(feat))
    feat = (x, None)
    for i in range(n_blocks):
        feat = getattr(model, f"block{i}")(feat, y)
        if model.training:
            feat = tuple(
                None if v is None
                else getattr(model, f"{kind}_noise{i}")(v, draw_noise(v, generator))
                for kind, v in zip(("lcl", "glb"), feat)
            )
    return resize_output(model.to_rgb(feat))


class FFCGenerator(nn.Module):
    """Parametric FFC DCGAN-style generator; output resolution is
    ``mg * 2 ** len(channel_mults)``. Block i maps ``ngf * mults[i-1]``
    channels (``ngf * 8`` for the first) to ``ngf * mults[i]``."""

    def __init__(
        self, z_size: int = 128, ngf: int = 64, ratio_g: float = 0.25,
        mg: int = 4, channel_mults: Sequence[int] = (4, 2, 1),
        out_channels: int = 3, generator: Optional[torch.Generator] = None,
        packed: Optional[bool] = None,
    ):
        """``packed``: packed-branch mode; None takes it from
        ``PACKED_MIN_RES`` px on."""
        super().__init__()
        self.z_size, self.ngf, self.mg = z_size, ngf, mg
        self.channel_mults = tuple(channel_mults)
        self.packed = self.resolution >= PACKED_MIN_RES if packed is None else packed
        self.noise_to_feature = Dense(z_size, mg * mg * ngf * 8)
        add_ladder(self, ngf * 8, ngf, ratio_g, self.channel_mults, out_channels, self.packed)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    @property
    def resolution(self) -> int:
        return self.mg * 2 ** len(self.channel_mults)

    @staticmethod
    def for_resolution(resolution: int, z_size: int = 128, out_channels: int = 3,
                       **kw) -> "FFCGenerator":
        """The preset of ``resolution`` (``PRESETS``), or, for any other
        ``mg·2^n`` (``mg`` from ``kw``, 4 by default), ngf 64 and ratio 0.25
        with the last n of the mults (4, 2, 1, 1, ...); ``kw`` overrides."""
        if resolution in PRESETS:
            cfg = dict(PRESETS[resolution])
        else:
            mg = kw.pop("mg", 4)
            n = (resolution // mg).bit_length() - 1 if resolution >= mg > 0 else -1
            if n < 0 or mg * 2 ** n != resolution:
                raise ValueError(
                    f"no generator preset for {resolution}px (have {sorted(PRESETS)}), "
                    f"and it is no mg*2^n (mg={mg})"
                )
            mults = ((4, 2, 1) + (1,) * max(0, n - 3))[-n:] if n else (1,)
            cfg = dict(ngf=64, ratio_g=0.25, mg=mg, channel_mults=mults)
        cfg.update(kw)
        return FFCGenerator(z_size=z_size, out_channels=out_channels, **cfg)

    def forward(
        self, z: torch.Tensor, compute_dtype=torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, z_size) -> (B, out_channels, R, R) in ``compute_dtype``.

        In training mode BatchNorm and the FourierUnits use batch
        statistics and update their running ones, and each block's output
        gets noise drawn from ``generator`` (a generator on z's device,
        required in training); eval ignores it."""
        if self.training and generator is None:
            raise ValueError("a training forward needs a noise generator")
        dt = resolve_dtype(compute_dtype)
        b = z.shape[0]
        stem = self.noise_to_feature(z.to(dt))
        # the Dense output is laid out NHWC, as in the JAX package
        x = stem.view(b, self.mg, self.mg, -1).permute(0, 3, 1, 2).contiguous()
        return run_ladder(self, x, len(self.channel_mults), generator)


# SN-conv discriminator ladders: (features, kernel, stride), padding 1.
D_LADDERS = {
    32: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
         (256, 4, 2), (512, 3, 1)),
    64: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
         (256, 4, 2), (512, 3, 1), (512, 4, 2)),
    128: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
          (256, 4, 2), (512, 3, 1), (512, 4, 2), (512, 4, 2)),
    256: ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1),
          (256, 4, 2), (512, 3, 1), (512, 4, 2), (512, 4, 2), (512, 4, 2)),
}


class SNConvDiscriminator(nn.Module):
    """Spectral-normed conv ladder over ``in_channels``-channel images with
    LeakyReLU(0.1) between layers and an SN dense head on the flattened
    (H, W, C) features; ``head_size`` is the side of the last map. With
    ``use_sn=False`` (the reference's ``sn=False`` escape hatch) the convs
    are plain ones with a bias and the head a plain dense layer. Returns
    (B, 1) logits."""

    def __init__(
        self, ladder: Sequence[Tuple[int, int, int]] = D_LADDERS[32],
        head_size: int = 4, generator: Optional[torch.Generator] = None,
        use_sn: bool = True, in_channels: int = 3,
    ):
        super().__init__()
        self.ladder = tuple(ladder)
        self.use_sn = use_sn
        cin = in_channels
        for i, (feat, k, s) in enumerate(self.ladder):
            conv = (SNConv2d(cin, feat, k, stride=s, padding=1) if use_sn
                    else Conv2d(cin, feat, k, stride=s, padding=1, bias=True))
            self.add_module(f"conv{i}", conv)
            cin = feat
        head = head_size * head_size * cin
        self.fc = SNDense(head, 1) if use_sn else Dense(head, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    @staticmethod
    def for_resolution(resolution: int, **kw) -> "SNConvDiscriminator":
        """The ladder of ``resolution``; 48 and 96 take the 32 and 64
        ladders with a head of side 6 (``mg``, which ``kw`` may set)."""
        mg = kw.pop("mg", 6 if resolution in (48, 96) else 4)
        base = {48: 32, 96: 64}.get(resolution, resolution)
        if base not in D_LADDERS:
            raise ValueError(
                f"no discriminator ladder for {resolution}px; have {sorted(D_LADDERS)} "
                f"and 48, 96"
            )
        return SNConvDiscriminator(ladder=D_LADDERS[base], head_size=mg, **kw)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """(B, C, R, R) images -> (B, 1) logits in ``compute_dtype``; without
        spectral norm the head computes in f32, as flax's Dense promotes
        its input to its f32 parameters, and the logits are f32."""
        x = x.to(resolve_dtype(compute_dtype))
        for i in range(len(self.ladder)):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), negative_slope=0.1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc(x if self.use_sn else x.float())


class FFCDiscriminator(nn.Module):
    """The all-FFC discriminator (the JAX package's ``FFCDiscriminator``):
    four tuple-path FFC_BN_ACT blocks (biased convolutions, LeakyReLU 0.1;
    BN from the second block), the branches concatenated, flattened in (H,
    W, C) order and an SN dense head over ``mg * mg * 512`` features (mg =
    resolution / 8). The second and third blocks' g2g branches hold a
    FourierUnit each: at 32px and ratio 0.25 on (B, 16, 16, 16) and
    (B, 32, 8, 8) maps. Returns (B, 1) logits."""

    def __init__(self, mg: int = 4, ratio_g: float = 0.25, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # (out channels, kernel, stride, global ratio in and out, norm), padding 1
        blocks = ((64, 3, 1, 0.0, ratio_g, "identity"), (128, 4, 2, ratio_g, ratio_g, "batch"),
                  (256, 4, 2, ratio_g, ratio_g, "batch"), (512, 4, 2, ratio_g, 0.0, "batch"))
        self.n_blocks = len(blocks)
        cin = in_channels
        for i, (cout, k, s, gin, gout, norm) in enumerate(blocks):
            self.add_module(f"block{i}", FFC_BN_ACT(
                cin, cout, k, gin, gout, stride=s, padding=1, norm=norm,
                activation="leaky_relu", use_bias=True,
            ))
            cin = cout
        self.fc = SNDense(mg * mg * cin, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """(B, C, R, R) images -> (B, 1) logits in ``compute_dtype``."""
        feat = (x.to(resolve_dtype(compute_dtype)), None)
        for i in range(self.n_blocks):
            feat = getattr(self, f"block{i}")(feat)
        m = resize_output(feat)
        return self.fc(m.permute(0, 2, 3, 1).reshape(m.shape[0], -1))
