"""VGG16 feature extractor ("vgg16") and the LPIPS sample similarity
("lpips-vgg16"), the JAX package's ``eval/lpips.py``.

  * ``VGG16Features``: torchvision's ``vgg16().features`` (13 3x3
    convolutions with ReLU, 2x2 max-pools between the five blocks),
    returning the five ReLU taps relu1_2 ... relu5_3.
  * ``VGG16``: the fc2 / fc2_relu extractor PRC reads (torch-fidelity's
    feature_extractor_vgg16.py): the uint8 (B, H, W, 3) input cast to the
    network's dtype, TF1-exact bilinear resize to 224, the 255-scaled
    torchvision normalisation, the backbone, the final pool, then the two
    4096-wide linears of the classifier.
  * ``LPIPS``: the distance between two [0, 255] batches (torch-fidelity's
    sample_similarity_lpips.py): an optional resize with torch's
    ``F.interpolate`` (``area`` when both sides shrink, bilinear with
    ``align_corners=False`` otherwise), the shift/scale normalisation, each
    tap unit-normalised over channels as ``f / (|f| + 1e-10)``, the squared
    difference through five bias-free 1x1 heads, each averaged over space,
    the five summed.

The network runs NCHW. Parameter names are the upstream ones, so real
checkpoints load with a strict ``load_state_dict`` and need no converter:
torchvision's ``features.{0,2,5,...,28}`` and ``classifier.{0,3}`` (the
1000-class ``classifier.6`` is dropped on load: no feature reads it), and
the toshas LPIPS heads' ``lin{i}.model.1.weight``; LPIPS's backbone
(``net.*``) loads from a torchvision file's ``features.*``. Flattened NCHW,
the final pool's output has torchvision's (C, H, W) order, so
``classifier.0.weight`` is taken as it is.

Weights: a torchvision vgg16 file (``weights_path`` or
``$FFC_TPU_VGG16_WEIGHTS``) and the toshas heads (``lpips_weights`` or
``$FFC_TPU_LPIPS_WEIGHTS``). Nothing is ever downloaded. Without a file the
nets are weights-free: convolutions and linears normal with variance
1 / fan_in, zero biases, heads uniform in [0, 0.1), drawn from a
``torch.Generator`` seeded 0, so their numbers are relative trends, and not
the JAX package's weights-free numbers (its weights come from
``jax.random``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.policy import resolve_device
from .inception import internal_dtype_of
from .resize import resize_bilinear_tf1

# (channels, convolutions) of the five blocks
VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_CHANNELS = tuple(c for c, _ in VGG_PLAN)
VGG16_FEATURES = ("fc2", "fc2_relu")
VGG16_WEIGHTS_ENV_VAR = "FFC_TPU_VGG16_WEIGHTS"
LPIPS_WEIGHTS_ENV_VAR = "FFC_TPU_LPIPS_WEIGHTS"
# torchvision's normalisation on the [0, 255] scale (feature_extractor_vgg16.py)
_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
# LPIPS's shift and scale (sample_similarity_lpips.py:115-120)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Sequential):
    """torchvision's ``vgg16().features`` without its last pool (which holds
    no parameters): ``forward`` returns the five block outputs (after ReLU).
    Index i of the Sequential is torchvision's ``features.i``."""

    def __init__(self):
        layers, taps, cin = [], [], 3
        for bi, (cout, n) in enumerate(VGG_PLAN):
            for _ in range(n):
                layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
                cin = cout
            taps.append(len(layers) - 1)
            if bi < len(VGG_PLAN) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.tap_after = tuple(taps)

    def forward(self, x: torch.Tensor):
        taps = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.tap_after:
                taps.append(x)
        return tuple(taps)


def _rgb_constant(values, scale: float, x: torch.Tensor) -> torch.Tensor:
    """(1, 3, 1, 1) constant, computed in float32 like the JAX package's."""
    return (torch.tensor(values, dtype=torch.float32) * scale).to(x).view(1, 3, 1, 1)


class VGG16(nn.Module):
    """``forward(uint8 (B, H, W, 3)) -> {tap: (B, 4096)}`` for the taps of
    ``features_list`` ('fc2', 'fc2_relu'); computes in the parameters'
    dtype, returns float32."""

    def __init__(self, features_list: Sequence[str] = ("fc2_relu",)):
        super().__init__()
        unknown = [f for f in features_list if f not in VGG16_FEATURES]
        if unknown or not features_list:
            raise ValueError(f"features_list {tuple(features_list)}: want taps of "
                             f"{VGG16_FEATURES}")
        self.features_list = tuple(features_list)
        self.features = VGG16Features()
        # torchvision's indices: the ReLUs and Dropouts hold the places of
        # classifier.1, 2, 4, 5 (forward calls the two linears itself)
        self.classifier = nn.Sequential(nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                                        nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout())

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"VGG16 takes uint8 (B, H, W, 3) images, got {x.dtype} "
                             f"{tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2).to(self.classifier[0].weight.dtype)
        x = resize_bilinear_tf1(x, (224, 224), align_corners=False, layout="NCHW")
        x = (x - _rgb_constant(_VGG_MEAN, 255.0, x)) / _rgb_constant(_VGG_STD, 255.0, x)
        x = F.max_pool2d(self.features(x)[-1], 2, 2).flatten(1)
        fc2 = self.classifier[3](F.relu(self.classifier[0](x)))
        out = {}
        if "fc2" in self.features_list:
            out["fc2"] = fc2.float()
        if "fc2_relu" in self.features_list:
            out["fc2_relu"] = F.relu(fc2).float()
        return out


class _Head(nn.Module):
    """The toshas LPIPS head: dropout (identity in eval) and a bias-free 1x1
    convolution to one channel, ``model.1.weight`` (1, C, 1, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def resize_area_or_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """LPIPS's resize of an NCHW batch to (size, size): ``area`` when both
    sides shrink, bilinear (``align_corners=False``) otherwise, nothing
    where the size is already right."""
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (size, size):
        return x
    if in_h > size and in_w > size:
        return F.interpolate(x, size=(size, size), mode="area")
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


class LPIPS(nn.Module):
    """``forward(x0, x1) -> (B,)``: the LPIPS distance between two [0, 255]
    batches (B, H, W, 3), uint8 or float, in the parameters' dtype."""

    def __init__(self, resize: Optional[int] = 64):
        super().__init__()
        self.resize = resize
        self.net = VGG16Features()
        for i, c in enumerate(LPIPS_CHANNELS):
            self.add_module(f"lin{i}", _Head(c))

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.lin0.model[1].weight.dtype)
        if self.resize is not None:
            x = resize_area_or_bilinear(x, self.resize)
        shift = (torch.tensor(_LPIPS_SHIFT) + 1) * 255.0 / 2
        inv_scale = 2.0 / (torch.tensor(_LPIPS_SCALE) * 255.0)
        return (x - shift.to(x).view(1, 3, 1, 1)) * inv_scale.to(x).view(1, 3, 1, 1)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        taps0, taps1 = self.net(self._prep(x0)), self.net(self._prep(x1))
        total = 0.0
        for i, (f0, f1) in enumerate(zip(taps0, taps1)):
            n0 = f0 / (f0.square().sum(1, keepdim=True).sqrt() + 1e-10)
            n1 = f1 / (f1.square().sum(1, keepdim=True).sqrt() + 1e-10)
            total = total + getattr(self, f"lin{i}")((n0 - n1).square()).mean(dim=(1, 2, 3))
        return total


# --- weights ------------------------------------------------------------------------------

# torchvision vgg16().features indices of the 13 convolutions
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _state_dict_of(path_or_dict) -> Dict[str, torch.Tensor]:
    if isinstance(path_or_dict, (str, bytes, os.PathLike)):
        return torch.load(path_or_dict, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v) for k, v in path_or_dict.items()}


def load_vgg16_torch_weights(model: VGG16, path_or_dict) -> VGG16:
    """A torchvision vgg16 state dict (a ``.pth`` path or the dict) into
    ``model``, strictly, ``classifier.6`` dropped."""
    state = {k: v for k, v in _state_dict_of(path_or_dict).items()
             if not k.startswith("classifier.6.")}
    model.load_state_dict(state, strict=True)
    return model


def load_lpips_torch_weights(model: LPIPS, lpips_path=None, vgg_path=None) -> LPIPS:
    """The toshas heads (``lin{i}.model.1.weight``) of ``lpips_path`` and the
    backbone of a torchvision vgg16 state dict's ``features.*`` at
    ``vgg_path`` (each a path or the dict, each where given) into ``model``,
    strictly."""
    if lpips_path is not None:
        heads = _state_dict_of(lpips_path)
        for i in range(len(LPIPS_CHANNELS)):
            getattr(model, f"lin{i}").load_state_dict(
                {"model.1.weight": heads[f"lin{i}.model.1.weight"]}, strict=True)
    if vgg_path is not None:
        vgg = _state_dict_of(vgg_path)
        model.net.load_state_dict({k[len("features."):]: v for k, v in vgg.items()
                                   if k.startswith("features.")}, strict=True)
    return model


def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Weights-free weights: every convolution and linear weight normal with
    variance 1 / fan_in (not truncated: a truncated draw of VGG16's 138M
    weights takes seconds), biases zero, LPIPS heads uniform in [0, 0.1), in
    the order of ``named_modules``."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            if isinstance(m, nn.Conv2d) and m.bias is None:  # an LPIPS head
                m.weight.uniform_(0.0, 0.1, generator=generator)
                continue
            m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
            m.bias.zero_()
    return model


def vgg16_weights_path(weights_path: Optional[str] = None) -> Optional[str]:
    """``weights_path``, else ``$FFC_TPU_VGG16_WEIGHTS``; None: weights-free."""
    return weights_path or os.environ.get(VGG16_WEIGHTS_ENV_VAR) or None


def create_vgg16(features_list: Sequence[str] = ("fc2_relu",), weights_path: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 internal_dtype: Optional[str] = None, device="cuda") -> VGG16:
    """The VGG16 extractor in eval mode on ``device``, in ``internal_dtype``:
    a torchvision vgg16 file's weights (``vgg16_weights_path``), else
    weights-free (``generator``: a CPU generator seeded 0 by default)."""
    dtype = internal_dtype_of(internal_dtype)
    model = _unset(VGG16, features_list)
    path = vgg16_weights_path(weights_path)
    if path is not None:
        load_vgg16_torch_weights(model, path)
    else:
        lecun_normal_(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    return model.to(device=resolve_device(device), dtype=dtype).eval()


def _unset(cls, *args) -> nn.Module:
    """``cls(*args)`` on the CPU with its parameters allocated and not
    initialised (a default init of VGG16's 138M weights takes seconds, and
    the caller sets every one)."""
    with torch.device("meta"):
        model = cls(*args)
    return model.to_empty(device="cpu")


def create_lpips(resize: Optional[int] = 64, lpips_weights: Optional[str] = None,
                 vgg_weights: Optional[str] = None, generator: Optional[torch.Generator] = None,
                 device="cuda") -> LPIPS:
    """LPIPS in eval mode on ``device``, float32: weights-free (as
    ``create_vgg16``), then the heads of ``lpips_weights`` (or
    ``$FFC_TPU_LPIPS_WEIGHTS``) and the backbone of ``vgg_weights`` (or
    ``$FFC_TPU_VGG16_WEIGHTS``) where they are given."""
    model = lecun_normal_(_unset(LPIPS, resize), generator if generator is not None
                          else torch.Generator().manual_seed(0))
    lpips_weights = lpips_weights or os.environ.get(LPIPS_WEIGHTS_ENV_VAR) or None
    load_lpips_torch_weights(model, lpips_weights, vgg16_weights_path(vgg_weights))
    return model.to(resolve_device(device)).eval()
