"""Registries of the metric pipeline, the JAX package's ``eval/registry.py``:
eval-side datasets, feature extractors and noise sources.

A feature extractor's factory is called as ``factory(features_list,
weights_path, internal_dtype=..., device=...)`` and returns a module in
eval mode on ``device`` that maps uint8 (B, H, W, 3) images to
``{tap: (B, D)}``. A noise source maps ``(generator, shape)`` to a float
tensor on the generator's device. Registering a name twice raises
``ValueError``.

Not here yet (ROADMAP queue 1 item 8b): the VGG16, CLIP and DINOv2
extractors, the LPIPS sample similarity and the PPL interpolations.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .inception import DEFAULT_FEATURE_LAYER, FEATURE_NAMES, create_extractor


def _random_unit(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform noise normalised to unit length over the last axis
    (torch-fidelity's random_unit: normalised uniform, not normal)."""
    v = torch.rand(shape, generator=generator, device=generator.device)
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-7)


NOISE_SOURCES: Dict[str, Callable] = {
    "normal": lambda g, shape: torch.randn(shape, generator=g, device=g.device),
    "unit": _random_unit,
    "uniform_0_1": lambda g, shape: torch.rand(shape, generator=g, device=g.device),
}
FEATURE_EXTRACTORS: Dict[str, dict] = {
    "inception-v3-compat": {
        "factory": create_extractor,
        "provided": FEATURE_NAMES,
        # torch-fidelity's feature_extractor_inceptionv3.py defaults
        "default_layers": dict(DEFAULT_FEATURE_LAYER),
    },
}
# dataset name -> callable () -> uint8 ndarray (N, H, W, 3)
_DATASETS: Dict[str, Callable[[], np.ndarray]] = {}


def _add(table: dict, kind: str, name: str, value) -> None:
    if name in table:
        raise ValueError(f"{kind} '{name}' is registered already")
    table[name] = value


def register_feature_extractor(name: str, factory: Callable,
                               default_layers: Optional[Dict[str, str]] = None,
                               provided: Optional[Sequence[str]] = None) -> None:
    """Register an extractor factory (see the module docstring).
    ``default_layers`` maps a metric name to the tap it reads by default;
    without it, callers pass ``feature_layer_*``."""
    entry = {"factory": factory, "provided": tuple(provided or ())}
    if default_layers:
        entry["default_layers"] = dict(default_layers)
    _add(FEATURE_EXTRACTORS, "feature extractor", name, entry)


def register_noise_source(name: str, fn: Callable) -> None:
    """Register a latent distribution ``fn(generator, shape) -> tensor``,
    the ``z_type`` of a :class:`pipeline.GenerativeModel`."""
    _add(NOISE_SOURCES, "noise source", name, fn)


def register_dataset(name: str, loader: Callable[[], np.ndarray]) -> None:
    """Register an eval-side real dataset: ``loader() -> uint8 (N, H, W, 3)``,
    called when a metric reads it under that name. A name registered again
    takes the new loader (the training CLI registers its real set on every
    run)."""
    _DATASETS[name] = loader


def registered_datasets() -> Sequence[str]:
    return tuple(_DATASETS)
