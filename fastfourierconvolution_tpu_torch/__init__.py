"""PyTorch and CUDA port of fastfourierconvolution_tpu for NVIDIA Hopper.

This slice serves the FFC generator in eval mode: ``serving.Generator``
turns latents into uint8 NHWC images. The FourierUnit runs as a
hand-written CUDA kernel on the card (``csrc/fourier_unit_fwd.cu``) and as
its plain PyTorch version on the CPU. ``bridge.jax_to_state_dict`` loads
the JAX package's variables. The package imports torch and numpy only.
"""

from .models.ffc_gan import FFCGenerator, to_uint8
from .serving import Generator

__all__ = ["FFCGenerator", "Generator", "to_uint8"]
