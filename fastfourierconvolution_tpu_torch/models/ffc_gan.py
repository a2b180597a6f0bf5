"""FFC-GAN generator (unconditional, tuple path) and the uint8 contract.

z -> Dense(mg*mg*ngf*8) -> (B, mg, mg, ngf*8) -> NCHW ->
[FFC_BN_ACT(k4 s2 p1, BN, GELU, upsampling)] x N ->
FFC_BN_ACT(ngf -> out_ch, k3 s1 p1, tanh, no norm) -> concat branches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..nn.ffc import FFC_BN_ACT, resize_output, split_channels
from ..nn.layers import Dense, NoiseInjection, _require_eval, reset_parameters
from ..utils.policy import resolve_dtype

PRESETS = {
    32: dict(ngf=64, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1)),
    48: dict(ngf=64, ratio_g=0.25, mg=6, channel_mults=(4, 2, 1)),
    64: dict(ngf=64, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1, 1)),
    96: dict(ngf=64, ratio_g=0.25, mg=6, channel_mults=(4, 2, 1, 1)),
    128: dict(ngf=128, ratio_g=0.5, mg=4, channel_mults=(4, 2, 1, 1, 1)),
    256: dict(ngf=128, ratio_g=0.5, mg=4, channel_mults=(4, 2, 1, 1, 1, 1)),
}


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> [0, 255] uint8, truncating like a cast."""
    return (255.0 * (x.clamp(-1.0, 1.0) * 0.5 + 0.5)).to(torch.uint8)


class FFCGenerator(nn.Module):
    """Parametric FFC DCGAN-style generator; output resolution is
    ``mg * 2 ** len(channel_mults)``. Block i maps ``ngf * mults[i-1]``
    channels (``ngf * 8`` for the first) to ``ngf * mults[i]``."""

    def __init__(
        self, z_size: int = 128, ngf: int = 64, ratio_g: float = 0.25,
        mg: int = 4, channel_mults: Sequence[int] = (4, 2, 1),
        out_channels: int = 3, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.z_size, self.ngf, self.mg = z_size, ngf, mg
        self.channel_mults = tuple(channel_mults)
        self.noise_to_feature = Dense(z_size, mg * mg * ngf * 8)
        in_ch, in_ratio = ngf * 8, 0.0  # the stem output is all-local
        for i, mult in enumerate(self.channel_mults):
            out_ch = ngf * mult
            self.add_module(f"block{i}", FFC_BN_ACT(
                in_ch, out_ch, 4, in_ratio, ratio_g, stride=2, padding=1,
                norm="batch", activation="gelu", upsampling=True,
            ))
            out_cl, out_cg = split_channels(out_ch, ratio_g)
            self.add_module(f"lcl_noise{i}", NoiseInjection(out_cl))
            if out_cg > 0:
                self.add_module(f"glb_noise{i}", NoiseInjection(out_cg))
            in_ch, in_ratio = out_ch, ratio_g
        self.to_rgb = FFC_BN_ACT(
            in_ch, out_channels, 3, ratio_g, 0.0, stride=1, padding=1,
            norm="identity", activation="tanh",
        )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    @property
    def resolution(self) -> int:
        return self.mg * 2 ** len(self.channel_mults)

    @staticmethod
    def for_resolution(resolution: int, z_size: int = 128, **kw) -> "FFCGenerator":
        if resolution not in PRESETS:
            raise ValueError(
                f"no generator preset for {resolution}px; have {sorted(PRESETS)}"
            )
        return FFCGenerator(z_size=z_size, **{**PRESETS[resolution], **kw})

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """(B, z_size) -> (B, out_channels, R, R) in ``compute_dtype``."""
        _require_eval(self)
        dt = resolve_dtype(compute_dtype)
        b = z.shape[0]
        stem = self.noise_to_feature(z.to(dt))
        # the Dense output is laid out NHWC, as in the JAX package
        x = stem.view(b, self.mg, self.mg, -1).permute(0, 3, 1, 2).contiguous()
        feat = (x, None)
        for i in range(len(self.channel_mults)):
            feat = getattr(self, f"block{i}")(feat)
        return resize_output(self.to_rgb(feat))
