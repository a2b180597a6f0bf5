"""GAN losses, computed in f32 on (B, 1) discriminator outputs: hinge,
BCE, Wasserstein with the gradient penalty, and the aw-method's
combination of D's real and fake gradients.

The port's copy of the JAX package's ``train/losses.py``: hinge and
Wasserstein on raw logits, BCE on probabilities clipped to
[1e-7, 1 - 1e-7]. Everything stays on the device: no value leaves it and
no branch depends on one, so a CUDA graph can capture every loss.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import parallel

BCE_CLIP = 1e-7
GP_NORM_EPS = 1e-12


def _logits_f32(logits: torch.Tensor) -> torch.Tensor:
    if logits.dim() != 2 or logits.shape[1] != 1:
        raise ValueError(f"logits must be (B, 1), got {tuple(logits.shape)}")
    return logits.float()


# --- hinge ------------------------------------------------------------------


def hinge_loss_dis(fake_logits: torch.Tensor, real_logits: torch.Tensor) -> torch.Tensor:
    """mean(relu(1 - real)) + mean(relu(1 + fake))."""
    if fake_logits.shape != real_logits.shape:
        raise ValueError(
            f"fake and real logits differ in shape: {tuple(fake_logits.shape)} "
            f"vs {tuple(real_logits.shape)}"
        )
    fake, real = _logits_f32(fake_logits), _logits_f32(real_logits)
    return torch.relu(1.0 - real).mean() + torch.relu(1.0 + fake).mean()


def hinge_loss_gen(fake_logits: torch.Tensor) -> torch.Tensor:
    """-mean(fake)."""
    return -_logits_f32(fake_logits).mean()


# --- BCE ----------------------------------------------------------------------


def bce_loss(probs: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy of probabilities against a constant target,
    the probabilities clipped to [1e-7, 1 - 1e-7]."""
    p = probs.float().clamp(BCE_CLIP, 1.0 - BCE_CLIP)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def bce_loss_dis(fake_probs: torch.Tensor, real_probs: torch.Tensor) -> torch.Tensor:
    return bce_loss(real_probs, 1.0) + bce_loss(fake_probs, 0.0)


def bce_loss_gen(fake_probs: torch.Tensor) -> torch.Tensor:
    return bce_loss(fake_probs, 1.0)


# --- Wasserstein + gradient penalty -------------------------------------------


def wgan_loss_dis(fake_logits: torch.Tensor, real_logits: torch.Tensor) -> torch.Tensor:
    """mean(fake) - mean(real)."""
    return fake_logits.float().mean() - real_logits.float().mean()


def wgan_loss_gen(fake_logits: torch.Tensor) -> torch.Tensor:
    """-mean(fake)."""
    return -fake_logits.float().mean()


def interpolation_weights(real: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """eps ~ U(0, 1) of shape (B, 1, 1, 1), f32, from ``generator``; under a
    process group this process's rows of the global batch's draw."""
    return parallel.global_draw(
        lambda shape: torch.rand(shape, generator=generator, device=real.device),
        (real.shape[0], 1, 1, 1))


def gradient_penalty(d_of_x, real: torch.Tensor, fake: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """WGAN-GP penalty mean((||∇x D(x̂)|| - 1)²) on x̂ = eps·real + (1 -
    eps)·fake, one eps per item; the norm is sqrt(Σ g² + 1e-12) over each
    item's values. ``d_of_x(x) -> (B, 1)``; the gradient is taken with a
    graph, so the penalty differentiates into D's parameters."""
    eps = interpolation_weights(real, generator)
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_of_x(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt((grads.float() ** 2).sum(dim=(1, 2, 3)) + GP_NORM_EPS)
    return ((norms - 1.0) ** 2).mean()


# --- aw-method ----------------------------------------------------------------


def aw_combine(
    grads_real: Sequence[torch.Tensor], grads_fake: Sequence[torch.Tensor],
    real_logits: torch.Tensor, fake_logits: torch.Tensor, alpha1: float = 0.5,
    alpha2: float = 0.75, delta: float = 0.05, epsilon: float = 0.05,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The aw-method's weighting (normalised form) of D's real and fake
    gradients: returns (w_r·g_real + w_f·g_fake per tensor, w_r, w_f).

    With r, f the gradients flattened over all tensors, rs and fs the mean
    sigmoid of the real and fake logits:

    - real side losing (rs < alpha1 or rs < fs - delta): w_r = 1/|r| + eps,
      w_f = -r·f/(|f|²|r|) + eps where r·f <= 0, else eps;
    - real side winning (rs > alpha2 and rs > fs - delta): mirrored;
    - otherwise w_r = 1/|r| + eps, w_f = 1/|f| + eps;

    |r|² and |f|² each carry 1e-4. The regime is picked on the device."""
    if not alpha1 < alpha2:
        raise ValueError(f"alpha1 ({alpha1}) must be smaller than alpha2 ({alpha2})")
    r = torch.cat([g.reshape(-1) for g in grads_real])
    f = torch.cat([g.reshape(-1) for g in grads_fake])
    rdotr = torch.dot(r, r) + 1e-4
    fdotf = torch.dot(f, f) + 1e-4
    rdotf = torch.dot(r, f)
    r_norm, f_norm = torch.sqrt(rdotr), torch.sqrt(fdotf)
    rs = torch.sigmoid(real_logits.float()).mean()
    fs = torch.sigmoid(fake_logits.float()).mean()

    real_losing = (rs < alpha1) | (rs < fs - delta)
    real_winning = (rs > alpha2) & (rs > fs - delta)
    neg = rdotf <= 0
    eps = torch.full_like(rdotf, epsilon)
    w_r_lose = 1.0 / r_norm + epsilon
    w_f_lose = torch.where(neg, -rdotf / (fdotf * r_norm) + epsilon, eps)
    w_r_win = torch.where(neg, -rdotf / (rdotr * f_norm) + epsilon, eps)
    w_f_win = 1.0 / f_norm + epsilon
    w_r = torch.where(real_losing, w_r_lose, torch.where(real_winning, w_r_win, w_r_lose))
    w_f = torch.where(real_losing, w_f_lose, torch.where(real_winning, w_f_win, w_f_win))
    combined = [w_r * gr + w_f * gf for gr, gf in zip(grads_real, grads_fake)]
    return combined, w_r, w_f
