"""Eval-mode image server for an FFC generator.

``Generator.generate(z)`` takes (B, z_size) float32 latents and returns
(B, H, W, 3) uint8 NHWC images, the JAX package's output contract
(``GANTrainer.generate(..., uint8=True)``): BN running statistics, no
noise injection, [-1, 1] -> [0, 255] truncated.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .models.ffc_gan import FFCGenerator, to_uint8
from .utils.policy import resolve_device, resolve_dtype, default_dtype


class Generator:
    """Serves ``model`` on ``device`` in eval mode.

    ``state_dict`` (optional) replaces the model's own weights. The
    compute dtype defaults to bf16 on the card and f32 on the CPU.
    """

    def __init__(
        self, model: FFCGenerator, state_dict: Optional[Mapping] = None, *,
        device="cuda", dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else resolve_dtype(dtype)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_preset(
        cls, resolution: int, state_dict: Optional[Mapping] = None, *,
        z_size: int = 128, generator: Optional[torch.Generator] = None,
        device="cuda", dtype=None,
    ) -> "Generator":
        """A server for ``FFCGenerator.for_resolution(resolution)``."""
        model = FFCGenerator.for_resolution(resolution, z_size=z_size, generator=generator)
        return cls(model, state_dict, device=device, dtype=dtype)

    def generate(self, z, uint8: bool = True) -> torch.Tensor:
        """(B, z_size) latents -> (B, H, W, C) images on the server's device:
        uint8, or floats in the compute dtype when ``uint8`` is False."""
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        if z.dim() != 2 or z.shape[1] != self.model.z_size:
            raise ValueError(
                f"z must be (B, {self.model.z_size}), got {tuple(z.shape)}"
            )
        with torch.inference_mode():
            out = self.model(z, self.dtype).permute(0, 2, 3, 1)
            return (to_uint8(out) if uint8 else out).contiguous()
