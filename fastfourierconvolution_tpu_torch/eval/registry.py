"""Registries of the metric pipeline, the JAX package's ``eval/registry.py``:
eval-side datasets, feature extractors, sample similarities, noise sources
and latent interpolations.

A feature extractor's factory is called as ``factory(features_list,
weights_path, internal_dtype=..., device=...)`` and returns a module in
eval mode on ``device`` that maps uint8 (B, H, W, 3) images to
``{tap: (B, D)}``; its entry's ``has_weights(weights_path)`` says whether
real weights will load (a weights-free extractor's cached features carry
``-weights-free`` in their names). A sample similarity's factory is called
as ``factory(resize=..., lpips_weights=..., vgg_weights=..., device=...)``
and returns a module mapping two [0, 255] batches to (B,) distances. A
noise source maps ``(generator, shape)`` to a float tensor on the
generator's device; an interpolation maps ``(a, b, t)`` to a tensor.
Registering a name twice raises ``ValueError``.

Built in, as in the JAX package: "inception-v3-compat"; "vgg16" ('fc2',
'fc2_relu'; every metric reads 'fc2_relu'); the nine CLIP names ('clip')
and the four DINOv2 names ('dinov2'); "lpips-vgg16"; the noise sources
'normal', 'unit', 'uniform_0_1'; the interpolations 'lerp', 'slerp_any',
'slerp_unit'.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .clip import CLIP_NAMES, create_clip_extractor
from .dinov2 import DINOV2_NAMES, create_dinov2_extractor
from .inception import DEFAULT_FEATURE_LAYER, FEATURE_NAMES, create_extractor, weights_available
from .lpips import VGG16_FEATURES, create_lpips, create_vgg16, vgg16_weights_path
from .ppl import INTERPOLATIONS


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
METRICS = ("isc", "fid", "kid", "prc")
FEATURE_EXTRACTORS: Dict[str, dict] = {
    "inception-v3-compat": {
        "factory": create_extractor,
        "provided": FEATURE_NAMES,
        # torch-fidelity's feature_extractor_inceptionv3.py defaults
        "default_layers": dict(DEFAULT_FEATURE_LAYER),
        "has_weights": weights_available,
    },
    "vgg16": {
        "factory": create_vgg16,
        "provided": VGG16_FEATURES,
        # torch-fidelity's feature_extractor_vgg16.py defaults
        "default_layers": {m: "fc2_relu" for m in METRICS},
        "has_weights": lambda path: vgg16_weights_path(path) is not None,
    },
    **{name: {"factory": functools.partial(create_clip_extractor, name=name),
              "provided": ("clip",), "default_layers": {m: "clip" for m in METRICS},
              "has_weights": lambda path: path is not None} for name in CLIP_NAMES},
    **{name: {"factory": functools.partial(create_dinov2_extractor, name=name),
              "provided": ("dinov2",), "default_layers": {m: "dinov2" for m in METRICS},
              "has_weights": lambda path: path is not None} for name in DINOV2_NAMES},
}
SAMPLE_SIMILARITIES: Dict[str, Callable] = {"lpips-vgg16": create_lpips}
# dataset name -> callable () -> uint8 ndarray (N, H, W, 3)
_DATASETS: Dict[str, Callable[[], np.ndarray]] = {}


def _add(table: dict, kind: str, name: str, value) -> None:
    if name in table:
        raise ValueError(f"{kind} '{name}' is registered already")
    table[name] = value


def register_feature_extractor(name: str, factory: Callable,
                               default_layers: Optional[Dict[str, str]] = None,
                               provided: Optional[Sequence[str]] = None) -> None:
    """Register an extractor factory (see the module docstring), taken to
    load real weights. ``default_layers`` maps a metric name to the tap it
    reads by default; without it, callers pass ``feature_layer_*``."""
    entry = {"factory": factory, "provided": tuple(provided or ()),
             "has_weights": lambda path: True}
    if default_layers:
        entry["default_layers"] = dict(default_layers)
    _add(FEATURE_EXTRACTORS, "feature extractor", name, entry)


def register_sample_similarity(name: str, factory: Callable) -> None:
    """Register a PPL sample similarity (see the module docstring)."""
    _add(SAMPLE_SIMILARITIES, "sample similarity", name, factory)


def register_interpolation(name: str, fn: Callable) -> None:
    """Register a latent interpolation ``fn(a, b, t) -> tensor`` for PPL's
    ``interp``."""
    _add(INTERPOLATIONS, "interpolation", name, fn)


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
