"""Plain PyTorch reference of one GAN training step of the FFC-GAN scripts:
the generator's update, then one discriminator update, with hinge losses
and AdamW, the learning rate decayed linearly to 0 over the run.

- G update: latents z ~ N(0, 1) (B, z_size); fakes from the generator in
  training mode (noise injected); logits of D in training mode (its u
  advances); loss -mean(logits); AdamW on G.
- D update: new latents; fakes from the generator in training mode
  without gradients (its running statistics advance again); D in training
  mode on [fakes; reals] in one pass; loss mean(relu(1 - real)) +
  mean(relu(1 + fake)); AdamW on D.
- AdamW as ``torch.optim.AdamW``: decoupled weight decay 0.01, betas from
  the configuration, eps 1e-8 added to the bias-corrected root; the
  update t (from 0) takes lr * max(1 - t / total_steps, 0).

Random draws come from two ``torch.Generator``s the caller seeds: the
latents from one, the noise maps (drawn in the noise dtype the
configuration states) from the other, in the order the step uses them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .ffc_gan import F32, Precision, Tensors, discriminator_forward, generator_forward, is_buffer

WEIGHT_DECAY = 0.01
ADAM_EPS = 1e-8


class AdamW:
    """AdamW over the parameters of ``t`` (every name that is no buffer),
    in place."""

    def __init__(self, t: Tensors, lr: float, betas, total_steps: int):
        self.names = [k for k in t if not is_buffer(k)]
        self.lr, self.betas, self.total = lr, betas, total_steps
        self.m = {k: torch.zeros_like(t[k]) for k in self.names}
        self.v = {k: torch.zeros_like(t[k]) for k in self.names}
        self.count = 0

    @torch.no_grad()
    def step(self, t: Tensors, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        lr = self.lr * max(1.0 - self.count / self.total, 0.0)
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k in self.names:
            p, g, m, v = t[k], grads[k], self.m[k], self.v[k]
            p.mul_(1 - lr * WEIGHT_DECAY)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + ADAM_EPS, value=-lr / c1)


class TrainStep:
    """The pair's state (``g``, ``d``: tensors by name), both optimizers and
    both generators of draws; :meth:`step` runs one step on ``real`` (B, C,
    R, R) f32 and returns (loss_g, loss_d). ``first_grads`` holds each
    parameter's gradient of the first step, by "g." / "d." name."""

    def __init__(self, g: Tensors, d: Tensors, cfg: dict, train: dict, seed: int,
                 device, q: Precision = F32, batch_rows: Optional[int] = None):
        self.g, self.d, self.cfg, self.q = g, d, cfg, q
        betas = (train["beta1"], train["beta2"])
        self.g_opt = AdamW(g, train["lr"], betas, train["total_steps"])
        self.d_opt = AdamW(d, train["lr"], betas, train["total_steps"])
        self.z_gen = torch.Generator(device).manual_seed(seed)
        self.noise_gen = torch.Generator(device).manual_seed(seed + 1)
        self.noise_dtype = getattr(torch, train["noise_dtype"])
        self.device = device
        # the rows each loss averages over: all of them, or the first
        # ``batch_rows`` (a planted fault)
        self.batch_rows = batch_rows
        self.first_grads: Dict[str, torch.Tensor] = {}

    def _noise(self, shape):
        return torch.randn(shape, generator=self.noise_gen, device=self.device,
                           dtype=self.noise_dtype).float()

    def _latents(self, b: int) -> torch.Tensor:
        return torch.randn((b, self.cfg["z_size"]), generator=self.z_gen, device=self.device)

    def _rows(self, logits: torch.Tensor) -> torch.Tensor:
        return logits if self.batch_rows is None else logits[:self.batch_rows]

    def _grads(self, loss, t: Tensors, side: str) -> Dict[str, torch.Tensor]:
        names = [k for k in t if not is_buffer(k)]
        grads = dict(zip(names, torch.autograd.grad(loss, [t[k] for k in names])))
        if not self.first_grads.get(side):
            self.first_grads[side] = {k: v.detach().clone() for k, v in grads.items()}
        return grads

    def step(self, real: torch.Tensor):
        b = real.shape[0]
        g_params = [k for k in self.g if not is_buffer(k)]
        for k in g_params:
            self.g[k].requires_grad_(True)
        fake = generator_forward(self.g, self.cfg, self._latents(b), True, self._noise, self.q)
        loss_g = -self._rows(discriminator_forward(self.d, self.cfg, fake, True, self.q)).mean()
        grads = self._grads(loss_g, self.g, "g")
        for k in g_params:
            self.g[k].requires_grad_(False)
        self.g_opt.step(self.g, grads)

        with torch.no_grad():
            fake = generator_forward(self.g, self.cfg, self._latents(b), True, self._noise,
                                     self.q)
        d_params = [k for k in self.d if not is_buffer(k)]
        for k in d_params:
            self.d[k].requires_grad_(True)
        fake_l, real_l = discriminator_forward(self.d, self.cfg, torch.cat([fake, real]), True,
                                               self.q).chunk(2)
        loss_d = (torch.relu(1.0 - self._rows(real_l)).mean()
                  + torch.relu(1.0 + self._rows(fake_l)).mean())
        grads = self._grads(loss_d, self.d, "d")
        for k in d_params:
            self.d[k].requires_grad_(False)
        self.d_opt.step(self.d, grads)
        return loss_g.detach(), loss_d.detach()


def run_steps(step: TrainStep, reals: List[torch.Tensor]):
    """``step`` over each of ``reals`` (NHWC, as the measured trainer
    takes them); returns the losses [(loss_g, loss_d)] as floats."""
    out = []
    for real in reals:
        loss_g, loss_d = step.step(real.permute(0, 3, 1, 2).float())
        out.append((float(loss_g), float(loss_d)))
    return out
