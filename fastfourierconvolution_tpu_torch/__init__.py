"""PyTorch and CUDA port of fastfourierconvolution_tpu for NVIDIA Hopper.

``serving.Generator`` turns latents into uint8 NHWC images with the FFC
generator in eval mode; ``train.gan.GANTrainer`` trains the generator
(packed-branch mode from 128px) against the spectral-normed conv
discriminator or the all-FFC one, step by step or K steps as one
captured CUDA graph (``update_steps``), and samples it (``generate``);
with ``conditional`` it trains the class-conditional models of
``models/conditional.py`` on labels. ``zoo.build_models`` turns a config
of ``utils/config.py`` (``make_config(preset)``, any of the JAX package's
ten presets) into the (generator, discriminator) pair it names, the
comparator models of ``models/dcgan.py``, ``models/sngan_resnet.py`` and
``models/sagan.py`` (plain PyTorch layers: convolutions, BN,
self-attention, no hand-written kernel) included. The FourierUnit and the packed
blocks' fused BN + GELU run as hand-written CUDA kernels on the card (``csrc/fourier_unit_fwd.cu``
for the forward, ``csrc/fourier_unit_train.cu`` for the batch statistics
and the backward, ``csrc/bn_act.cu`` for the fused BN family) and as
their plain PyTorch versions on the CPU.
``bridge.jax_to_state_dict`` loads the JAX package's variables. The
package imports torch and numpy only.
"""

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
from .models.ffc_gan import FFCDiscriminator, FFCGenerator, SNConvDiscriminator, to_uint8
from .models.sagan import SAGANDiscriminator, SAGANGenerator
from .models.sngan_resnet import (
    DBlock,
    DBlockOptimized,
    GBlock,
    SNGANDiscriminator,
    SNGANGenerator,
)
from .serving import Generator
from .train.gan import GANTrainer
from .utils.config import PRESETS, Config, apply_overrides, make_config
from .zoo import TupleHeadWrapper, build_discriminator, build_generator, build_models

__all__ = [
    "AttnConvGenerator", "CondDCGANDiscriminator", "CondDCGANGenerator",
    "CondSNDiscriminator", "Config", "DBlock", "DBlockOptimized", "DCGANDiscriminator",
    "DCGANGenerator", "FFCCondDCGANDiscriminator", "FFCCondDiscriminator",
    "FFCCondGenerator", "FFCDiscriminator", "FFCGenerator", "GANTrainer", "GBlock",
    "Generator", "PRESETS", "SAGANDiscriminator", "SAGANGenerator", "SNConvDiscriminator",
    "SNDCGANDiscriminator", "SNGANDiscriminator", "SNGANGenerator", "TupleHeadWrapper",
    "apply_overrides", "build_discriminator", "build_generator", "build_models",
    "make_config", "to_uint8",
]
