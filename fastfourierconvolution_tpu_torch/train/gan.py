"""GAN training step for an (FFCGenerator, SNConvDiscriminator) pair.

``GANTrainer.update_step`` is the JAX package's ``GANTrainer.update_step``
with the G-first order, one D update on a fused ``[fake; real]`` batch
and the hinge loss:

1. G phase: a generator forward in training mode (batch-statistic BN,
   noise), a discriminator forward on the fakes (its spectral-norm ``u``
   advances), the generator's gradients taken over its own parameters
   only, an AdamW step.
2. D phase: a generator forward in training mode without a graph (its
   running statistics advance again), one discriminator forward on
   ``cat([fake, real])``, the discriminator's gradients, an AdamW step.

AdamW (betas 0.5/0.999, eps 1e-8, weight decay 0.01 on every parameter)
with lr(t) = lr * max(1 - t/total, 0) at update t: torch's AdamW and
optax's adamw apply the same update, p -= lr * (m̂ / (sqrt(v̂) + eps) +
wd * p) with bias-corrected moments, eps outside the square root.

Latents and noise come from two ``torch.Generator``s on the trainer's
device, seeded at construction. Parameters, BN statistics and ``u`` stay
f32; activations run in the trainer's compute dtype.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..utils.policy import default_dtype, resolve_device, resolve_dtype
from .losses import hinge_loss_dis, hinge_loss_gen


BETAS = (0.5, 0.999)
WEIGHT_DECAY = 0.01


def _adamw(model: nn.Module, lr: float, total_steps: int):
    opt = torch.optim.AdamW(
        model.parameters(), lr=lr, betas=BETAS, eps=1e-8, weight_decay=WEIGHT_DECAY
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: max(1.0 - t / total_steps, 0.0)
    )
    return opt, sched


class GANTrainer:
    """Trains ``g_model`` and ``d_model`` in place on ``device`` (``cuda``
    unless told otherwise); the compute dtype defaults to bf16 on the card
    and f32 on the CPU."""

    def __init__(
        self, g_model: nn.Module, d_model: nn.Module, *, z_size: int = 128,
        lr: float = 2e-4, total_steps: int = 100_000, seed: int = 0,
        device="cuda", dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else resolve_dtype(dtype)
        self.z_size = z_size
        self.g = g_model.to(self.device).train()
        self.d = d_model.to(self.device).train()
        self.g_opt, self.g_sched = _adamw(self.g, lr, total_steps)
        self.d_opt, self.d_sched = _adamw(self.d, lr, total_steps)
        self.z_generator = torch.Generator(self.device).manual_seed(seed)
        self.noise_generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.step = 0

    def _latents(self, b: int) -> torch.Tensor:
        return torch.randn(
            (b, self.z_size), generator=self.z_generator, device=self.device
        )

    def g_loss_and_grads(self, z: torch.Tensor):
        """The G phase's loss and the generator's gradients (one tensor per
        parameter, in ``g_model.parameters()`` order). Advances G's running
        statistics and D's ``u``, as the phase does."""
        params = list(self.g.parameters())
        fake = self.g(z, self.dtype, self.noise_generator)
        loss = hinge_loss_gen(self.d(fake, self.dtype))
        return loss.detach(), torch.autograd.grad(loss, params)

    def update_step(self, real, zs=None) -> Dict[str, torch.Tensor]:
        """One G update, then one D update. ``real``: (B, H, W, C) images in
        [-1, 1] (NHWC, as the JAX package takes them); ``zs`` (optional,
        (2, B, z_size)) replaces the latent draws of the two phases.
        Returns the losses as f32 scalars on the device."""
        real = torch.as_tensor(real, dtype=torch.float32).to(self.device)
        if real.dim() != 4:
            raise ValueError(f"real must be (B, H, W, C), got {tuple(real.shape)}")
        b = real.shape[0]
        if zs is None:
            z_g, z_d = self._latents(b), self._latents(b)
        else:
            z_g, z_d = torch.as_tensor(zs, dtype=torch.float32).to(self.device)

        loss_g, grads = self.g_loss_and_grads(z_g)
        for p, grad in zip(self.g.parameters(), grads):
            p.grad = grad
        self.g_opt.step()
        self.g_sched.step()

        with torch.no_grad():
            fake = self.g(z_d, self.dtype, self.noise_generator)
        both = torch.cat([fake, real.permute(0, 3, 1, 2).to(self.dtype)])
        fake_logits, real_logits = self.d(both, self.dtype).chunk(2)
        loss_d = hinge_loss_dis(fake_logits, real_logits)
        self.d_opt.zero_grad(set_to_none=True)
        loss_d.backward()
        self.d_opt.step()
        self.d_sched.step()
        self.step += 1
        return {"loss_g": loss_g, "loss_d": loss_d.detach()}
