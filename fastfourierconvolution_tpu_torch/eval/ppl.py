"""Perceptual Path Length and the latent interpolations, the JAX package's
``eval/ppl.py`` (torch-fidelity's metric_ppl.py and noise.py).

Pairs of latents (e0, e1) with e1 = interp(e0, e1', epsilon); the sample
similarity (LPIPS over VGG16 by default) between G(e0) and G(e1), divided by
epsilon^2; the distances outside the 1st-99th percentiles dropped; mean and
standard deviation.

The latents (and a conditional model's labels) come from
``np.random.RandomState(rng_seed)`` in the JAX package's order (e0, e1',
labels), and the interpolation runs on the host in float32, so both packages
and every device see the same e0 and e1. This is not how the pipeline's
other generative inputs draw (``pipeline._batch_generator``). With epsilon
1e-4 a distance is the similarity times 1e8: one uint8 level changed in one
pixel moves it far beyond any float tolerance.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.policy import resolve_device

KEY_PPL_MEAN = "perceptual_path_length_mean"
KEY_PPL_STD = "perceptual_path_length_std"
KEY_PPL_RAW = "perceptual_path_length_raw"


def sample_random(rng: np.random.RandomState, shape, z_type: str) -> np.ndarray:
    """float32 noise of ``z_type`` ('normal', 'unit': uniform normalised to
    unit length over the last axis, 'uniform_0_1') from ``rng``."""
    if z_type == "normal":
        return rng.randn(*shape).astype(np.float32)
    if z_type == "unit":
        v = rng.rand(*shape).astype(np.float32)
        n = np.sqrt(np.sum(v ** 2, axis=-1, keepdims=True))
        return v / np.maximum(n, 1e-7)
    if z_type == "uniform_0_1":
        return rng.rand(*shape).astype(np.float32)
    raise ValueError(z_type)


def _normalize_last(v: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    return v / v.square().sum(-1, keepdim=True).sqrt().clamp_min(eps)


def batch_lerp(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    return a + (b - a) * t


def batch_slerp_any(a: torch.Tensor, b: torch.Tensor, t: float, eps: float = 1e-7):
    """Spherical interpolation of rows of any length; rows where either end
    is zero or the two are collinear fall back to lerp."""
    a_1, b_1 = _normalize_last(a, eps), _normalize_last(b, eps)
    d = (a_1 * b_1).sum(-1, keepdim=True)
    zero = ((torch.linalg.norm(a_1, dim=-1, keepdim=True) < eps)
            | (torch.linalg.norm(b_1, dim=-1, keepdim=True) < eps))
    use_lerp = zero | (d > 1 - eps) | (d < -1 + eps)
    omega = torch.arccos(d.clamp(-1.0, 1.0))
    denom = torch.sin(omega).clamp_min(eps)
    out = (torch.sin((1 - t) * omega) / denom) * a + (torch.sin(t * omega) / denom) * b
    return torch.where(use_lerp, batch_lerp(a, b, t), out)


def batch_slerp_unit(a: torch.Tensor, b: torch.Tensor, t: float, eps: float = 1e-7):
    return _normalize_last(batch_slerp_any(a, b, t, eps), eps)


INTERPOLATIONS: Dict[str, Callable] = {
    "lerp": batch_lerp,
    "slerp_any": batch_slerp_any,
    "slerp_unit": batch_slerp_unit,
}


def calculate_ppl(
    model,
    num_samples: int = 10000,
    epsilon: float = 1e-4,
    interp: str = "lerp",
    batch_size: int = 64,
    similarity_resize: Optional[int] = 64,
    discard_percentile_lower: Optional[float] = 1.0,
    discard_percentile_higher: Optional[float] = 99.0,
    rng_seed: int = 2020,
    lpips_weights: Optional[str] = None,
    vgg_weights: Optional[str] = None,
    reduction: str = "mean",
    similarity_name: str = "lpips-vgg16",
    device="cuda",
) -> Dict[str, float]:
    """PPL of a :class:`pipeline.GenerativeModel` (see the module docstring).
    The model's latents and labels go to its ``device`` (None: ``device``);
    the similarity, ``SAMPLE_SIMILARITIES[similarity_name]``, runs on
    ``device`` in float32 with TF32 off. ``reduction="none"`` adds the
    filtered distances under ``perceptual_path_length_raw``."""
    from .pipeline import _full_f32, _normalize_model_images
    from .registry import SAMPLE_SIMILARITIES

    if not epsilon > 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    if reduction not in ("mean", "none"):
        raise ValueError(f"reduction must be 'mean' or 'none', got {reduction!r}")
    if similarity_name not in SAMPLE_SIMILARITIES:
        raise KeyError(f"sample similarity '{similarity_name}' not registered; known: "
                       f"{list(SAMPLE_SIMILARITIES)}")
    device = resolve_device(device)
    at = resolve_device(model.device) if model.device is not None else device
    rng = np.random.RandomState(rng_seed)
    lat_e0 = sample_random(rng, (num_samples, model.z_size), model.z_type)
    lat_e1 = sample_random(rng, (num_samples, model.z_size), model.z_type)
    lat_e1 = INTERPOLATIONS[interp](torch.from_numpy(lat_e0), torch.from_numpy(lat_e1),
                                    epsilon).numpy()
    labels = (rng.randint(0, model.num_classes, (num_samples,)) if model.num_classes > 0
              else None)
    similarity = SAMPLE_SIMILARITIES[similarity_name](
        resize=similarity_resize, lpips_weights=lpips_weights, vgg_weights=vgg_weights,
        device=device)

    distances = []
    for begin in range(0, num_samples, batch_size):
        end = min(begin + batch_size, num_samples)
        e0 = torch.from_numpy(lat_e0[begin:end]).to(at)
        e1 = torch.from_numpy(lat_e1[begin:end]).to(at)
        extra = () if labels is None else (torch.from_numpy(labels[begin:end]).to(at),)
        img0 = _normalize_model_images(model.apply(e0, *extra))
        img1 = _normalize_model_images(model.apply(e1, *extra))
        with torch.inference_mode(), _full_f32():
            sim = similarity(img0.to(device), img1.to(device))
        distances.append(sim.float().cpu().numpy() / (epsilon ** 2))
    dist = np.concatenate(distances)

    cond = None
    if discard_percentile_lower is not None:
        cond = np.percentile(dist, discard_percentile_lower, method="lower") <= dist
    if discard_percentile_higher is not None:
        hi = dist <= np.percentile(dist, discard_percentile_higher, method="higher")
        cond = hi if cond is None else np.logical_and(cond, hi)
    if cond is not None:
        dist = np.extract(cond, dist)
    out = {KEY_PPL_MEAN: float(np.mean(dist)), KEY_PPL_STD: float(np.std(dist))}
    if reduction == "none":
        out[KEY_PPL_RAW] = dist
    return out
