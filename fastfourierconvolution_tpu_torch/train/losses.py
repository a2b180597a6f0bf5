"""Hinge GAN losses, computed in f32 on (B, 1) logits."""

from __future__ import annotations

import torch


def _logits_f32(logits: torch.Tensor) -> torch.Tensor:
    if logits.dim() != 2 or logits.shape[1] != 1:
        raise ValueError(f"logits must be (B, 1), got {tuple(logits.shape)}")
    return logits.float()


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
