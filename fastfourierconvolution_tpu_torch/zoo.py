"""The model registry, the JAX package's ``zoo.py``: a ``Config`` ->
(generator, discriminator) modules, by the same names.

``model.fourier_impl`` picks how the JAX package computes the FourierUnit's
transforms (``"fft"`` or ``"dft"``, or ``"auto"``/None to let it choose),
the same function computed two ways. The port's FFC models have one
implementation, the kernels, so the field takes the values the JAX
package takes without effect here, and any other value raises.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from .models.conditional import (
    CondDCGANDiscriminator,
    CondDCGANGenerator,
    CondSNDiscriminator,
    FFCCondDCGANDiscriminator,
    FFCCondDiscriminator,
    FFCCondGenerator,
)
from .models.dcgan import (
    AttnConvGenerator,
    DCGANDiscriminator,
    DCGANGenerator,
    SNDCGANDiscriminator,
)
from .models.ffc_gan import FFCDiscriminator, FFCGenerator, SNConvDiscriminator
from .models.sagan import SAGANDiscriminator, SAGANGenerator
from .models.sngan_resnet import SNGANDiscriminator, SNGANGenerator
from .utils.config import Config

FOURIER_IMPLS = (None, "fft", "dft", "auto")


def _check_fourier_impl(cfg: Config) -> None:
    if cfg.model.fourier_impl not in FOURIER_IMPLS:
        raise ValueError(f"unknown model.fourier_impl {cfg.model.fourier_impl!r}; "
                         f"want one of {FOURIER_IMPLS}")


def build_generator(cfg: Config) -> nn.Module:
    """The generator ``cfg.model.generator`` names; KeyError for an
    unknown name."""
    _check_fourier_impl(cfg)
    m, d = cfg.model, cfg.data
    if m.generator == "ffc":
        kw = dict(z_size=m.z_size, out_channels=d.channels, ngf=m.ngf, ratio_g=m.ratio_g)
        if d.image_size not in (32, 48, 64, 96, 128):
            kw["mg"] = m.mg  # generic ladder derivation
        return FFCGenerator.for_resolution(d.image_size, **kw)
    if m.generator == "ffc_cond":
        return FFCCondGenerator.for_preset(
            m.gen_preset or "cifar32", z_size=m.z_size, num_classes=m.num_classes, ngf=m.ngf,
            ratio_g=m.ratio_g, out_channels=d.channels)
    if m.generator == "dcgan":
        return DCGANGenerator(nz=m.z_size, nc=d.channels, ngf=m.ngf)
    if m.generator == "cond_dcgan":
        return CondDCGANGenerator(nz=m.z_size, nc=d.channels, ngf=m.ngf,
                                  num_classes=m.num_classes)
    if m.generator == "attn_dcgan":
        return AttnConvGenerator(z_size=m.z_size, mg=m.mg, ngf=m.ngf)
    if m.generator == "sngan_resnet":
        return SNGANGenerator(nz=m.z_size, ngf=m.ngf, bottom_width=4,
                              num_blocks=5 if d.image_size >= 128 else 3)
    if m.generator == "sagan":
        return SAGANGenerator(image_size=d.image_size, z_dim=m.z_size, conv_dim=m.ngf)
    raise KeyError(f"unknown generator '{m.generator}'")


def build_discriminator(cfg: Config) -> nn.Module:
    """The discriminator ``cfg.model.discriminator`` names, on
    ``cfg.data.channels``-channel images (the JAX models read the count
    from their input); KeyError for an unknown name."""
    _check_fourier_impl(cfg)
    m, d = cfg.model, cfg.data
    if m.discriminator == "sn_conv":
        return SNConvDiscriminator.for_resolution(d.image_size, mg=m.mg, in_channels=d.channels)
    if m.discriminator == "cond_sn_conv":
        return CondSNDiscriminator(num_classes=m.num_classes, resolution=d.image_size,
                                   in_channels=d.channels)
    if m.discriminator == "ffc":
        return FFCDiscriminator(mg=m.mg, ratio_g=m.ratio_g, in_channels=d.channels)
    if m.discriminator == "ffc_cond":
        return FFCCondDiscriminator(num_classes=m.num_classes, ratio_g=m.ratio_g,
                                    resolution=d.image_size, in_channels=d.channels)
    if m.discriminator == "dcgan":
        return DCGANDiscriminator(nc=d.channels, ndf=m.ndf)
    if m.discriminator == "sn_dcgan":
        return SNDCGANDiscriminator(nc=d.channels, ndf=m.ndf)
    if m.discriminator == "cond_dcgan":
        # the reference library's conditional D: BN conv ladder, decaying
        # input noise
        return CondDCGANDiscriminator(nc=d.channels, ndf=m.ndf, num_classes=m.num_classes,
                                      use_sn=False, use_noise=True)
    if m.discriminator == "ffc_cond_dcgan":
        return FFCCondDCGANDiscriminator(nc=d.channels, ndf=m.ndf, num_classes=m.num_classes)
    if m.discriminator == "sngan_resnet":
        return SNGANDiscriminator(ndf=m.ndf, num_blocks=5 if d.image_size >= 128 else 3,
                                  in_channels=d.channels)
    if m.discriminator == "sagan":
        return SAGANDiscriminator(image_size=d.image_size, conv_dim=m.ndf,
                                  in_channels=d.channels)
    raise KeyError(f"unknown discriminator '{m.discriminator}'")


class TupleHeadWrapper(nn.Module):
    """Hands the trainer the first element of a model that returns
    ``(images or logits, attention)``, the SAGAN pair. The wrapped model's
    variables are not nested under the wrapper in the JAX package, and
    ``bridge.jax_to_state_dict`` loads them into ``wrapper.module``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)[0]


def build_models(cfg: Config) -> Tuple[nn.Module, nn.Module]:
    """(generator, discriminator) of ``cfg``, each returning one tensor."""
    if cfg.model.conditional and cfg.model.num_classes < 2:
        raise ValueError(
            "model.conditional=true requires model.num_classes >= 2 "
            "(conditional presets set it; the train command infers it "
            "from labeled datasets)"
        )
    g = build_generator(cfg)
    d = build_discriminator(cfg)
    if cfg.model.generator == "sagan":
        g = TupleHeadWrapper(g)
    if cfg.model.discriminator == "sagan":
        d = TupleHeadWrapper(d)
    return g, d
