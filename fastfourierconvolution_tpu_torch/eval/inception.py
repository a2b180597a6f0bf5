"""InceptionV3 feature extractor ("inception-v3-compat"), the JAX package's
``eval/inception.py``.

The TF-weights-compatible InceptionV3 that torch-fidelity uses for FID, ISC
and KID (its feature_extractor_inceptionv3.py), with torch-fidelity's
parameter names, NCHW inside the network:

  * uint8 (B, H, W, 3) input, cast to the network's dtype, TF1-exact
    bilinear resize to 299 (align_corners=False), ``(x - 128) / 128``;
  * TF-patched blocks: InceptionA, C and E_1 pool with an average that
    leaves the padding out of the divisor; E_2 (``Mixed_7c``) max-pools;
  * feature taps '64', '192', '768', '2048', 'logits_unbiased', 'logits'
    with early exit, BN eps 1e-3, fc to 1008 classes.

Weights: torch-fidelity's ``.pth`` (``weights-inception-2015-12-05-6726825d.pth``)
loads as it is (``load_torch_weights``) where a local copy exists
(``weights_path``, ``$FFC_TPU_INCEPTION_WEIGHTS`` or torch hub's cache
directory, ``find_local_weights``). Nothing is ever downloaded.

Weights-free mode, without such a file: a randomly initialised deep stack
contracts every input to nearly the same point, so the defaults route to
shallow taps ('192', five convolutions) and 'logits_unbiased' comes from a
random projection of the pooled '192' features (``shallow_logits``: a
per-image layernorm, times 4, a 192 -> 1008 product). Such metrics are
relative trends, not comparable to published numbers, and not to the JAX
package's weights-free numbers either: the random weights come from a
``torch.Generator`` (seed 0, lecun-normal), not from ``jax.random``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.policy import resolve_device
from .resize import resize_bilinear_tf1

FEATURE_NAMES = ("64", "192", "768", "2048", "logits_unbiased", "logits")
DEFAULT_FEATURE_LAYER = {"isc": "logits_unbiased", "fid": "2048", "kid": "2048", "prc": "2048"}
# Weights-free defaults: the shallow taps keep images apart, the deep ones
# do not under random weights (see the module docstring).
DEFAULT_FEATURE_LAYER_WEIGHTS_FREE = {"isc": "logits_unbiased", "fid": "192", "kid": "192",
                                      "prc": "192"}
INTERNAL_DTYPES = {None: torch.float32, "float32": torch.float32, "float64": torch.float64}
WEIGHTS_ENV_VAR = "FFC_TPU_INCEPTION_WEIGHTS"
WEIGHTS_FILE = "weights-inception-2015-12-05-6726825d.pth"
# The per-image layernorm's gain in weights-free mode: a peaked softmax
# that varies with the image (ISC away from 1).
SHALLOW_LOGIT_GAIN = 4.0


def internal_dtype_of(name: Optional[str]) -> torch.dtype:
    """torch-fidelity's ``feature_extractor_internal_dtype``: None or
    'float32' (float32), 'float64' (float64); anything else raises."""
    if name not in INTERNAL_DTYPES:
        raise ValueError(f"feature_extractor_internal_dtype must be 'float32', 'float64' or "
                         f"None, got {name!r}")
    return INTERNAL_DTYPES[name]


class FrozenBatchNorm(nn.Module):
    """Inference-only BatchNorm (eps 1e-3, TF's, unless given): BatchNorm2d's
    parameters and running statistics, without ``num_batches_tracked``."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class BasicConv2d(nn.Module):
    """Convolution without bias, frozen BN, ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_tf(x):
    """3x3 stride-1 average that leaves the padding out of the divisor (TF)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x, stride: int = 2, padding: int = 0):
    return F.max_pool2d(x, 3, stride, padding)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_tf(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_tf(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """E block; ``pool="avg"`` for E_1 (TF's average-pool patch), ``"max"``
    for E_2 (TF's max-pool quirk, stride 1, padding 1)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"pool must be 'avg' or 'max', got {pool!r}")
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool_tf(x) if self.pool == "avg" else _max_pool(x, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """The extractor: ``forward(uint8 (B, H, W, 3)) -> {tap: (B, D)}`` for the
    taps of ``features_list``, stopping after the last one it needs. It
    computes in the dtype of its parameters (``.to(torch.float64)`` for
    torch-fidelity's float64 internal dtype), the input cast before the
    resize. ``shallow_logits`` (weights-free mode) adds the ``fc192``
    projection and drops the deep ``fc``."""

    def __init__(self, features_list: Sequence[str] = ("2048", "logits_unbiased"),
                 shallow_logits: bool = False):
        super().__init__()
        unknown = [f for f in features_list if f not in FEATURE_NAMES]
        if unknown or not features_list:
            raise ValueError(f"features_list {tuple(features_list)}: want taps of {FEATURE_NAMES}")
        self.features_list = tuple(features_list)
        self.shallow_logits = shallow_logits
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        if shallow_logits:
            self.fc192 = nn.Linear(192, 1008)
        else:
            self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"InceptionV3 takes uint8 (B, H, W, 3) images, got {x.dtype} "
                             f"{tuple(x.shape)}")
        wanted = self.features_list
        out: Dict[str, torch.Tensor] = {}
        done = lambda: len(out) == len(wanted)

        x = x.permute(0, 3, 1, 2).to(self.Conv2d_1a_3x3.conv.weight.dtype)
        x = resize_bilinear_tf1(x, (299, 299), align_corners=False, layout="NCHW")
        x = (x - 128.0) / 128.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        if "64" in wanted:
            out["64"] = x.mean(dim=(2, 3))
            if done():
                return out

        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        logits = "logits_unbiased" in wanted or "logits" in wanted
        if "192" in wanted or (self.shallow_logits and logits):
            pooled = x.mean(dim=(2, 3))
            if "192" in wanted:
                out["192"] = pooled
            if self.shallow_logits and logits:
                # per-image layernorm: the raw pooled magnitudes are tiny
                # under random weights, so bare logits give a near-uniform
                # softmax (ISC pinned at 1)
                mu = pooled.mean(dim=-1, keepdim=True)
                sd = pooled.std(dim=-1, keepdim=True, correction=0) + 1e-8
                unbiased = F.linear((pooled - mu) / sd, self.fc192.weight) * SHALLOW_LOGIT_GAIN
                if "logits_unbiased" in wanted:
                    out["logits_unbiased"] = unbiased
                if "logits" in wanted:
                    out["logits"] = unbiased + self.fc192.bias
            if done():
                return out

        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if "768" in wanted:
            out["768"] = x.mean(dim=(2, 3))
            if done():
                return out

        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x))).mean(dim=(2, 3))
        if "2048" in wanted:
            out["2048"] = x
            if done():
                return out
        unbiased = F.linear(x, self.fc.weight)
        if "logits_unbiased" in wanted:
            out["logits_unbiased"] = unbiased
        if "logits" in wanted:
            out["logits"] = unbiased + self.fc.bias
        return out


# --- weights ------------------------------------------------------------------------------


def find_local_weights() -> Optional[str]:
    """A local torch-fidelity InceptionV3 ``.pth``: ``$FFC_TPU_INCEPTION_WEIGHTS``,
    else torch hub's checkpoint cache; None where neither exists."""
    candidates = [
        os.environ.get(WEIGHTS_ENV_VAR, ""),
        os.path.expanduser(os.path.join("~/.cache/torch/hub/checkpoints", WEIGHTS_FILE)),
    ]
    return next((c for c in candidates if c and os.path.exists(c)), None)


def weights_available(weights_path: Optional[str] = None) -> bool:
    """True when real InceptionV3 weights will be used."""
    return (weights_path or find_local_weights()) is not None


def load_torch_weights(model: InceptionV3, path_or_dict) -> InceptionV3:
    """Load torch-fidelity's state dict (a ``.pth`` path or the dict) into
    ``model`` strictly, ``num_batches_tracked`` dropped."""
    if isinstance(path_or_dict, (str, bytes, os.PathLike)):
        path_or_dict = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    state = {k: v for k, v in path_or_dict.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=True)
    return model


def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Weights-free weights, as the JAX package draws them: every convolution
    and linear weight lecun-normal (a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in), in the order of
    ``named_parameters``; biases and BN as a fresh net has them."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv.weight") or name in ("fc.weight", "fc192.weight"):
                fan_in = p[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
            elif name in ("fc.bias", "fc192.bias"):
                p.zero_()
    return model


def create_extractor(features_list: Sequence[str] = ("2048", "logits_unbiased"),
                     weights_path: Optional[str] = None,
                     generator: Optional[torch.Generator] = None,
                     internal_dtype: Optional[str] = None, device="cuda") -> InceptionV3:
    """The extractor in eval mode on ``device``, in ``internal_dtype``
    (None or 'float32', or 'float64'): with torch-fidelity's weights where a
    file is given or found (``find_local_weights``), else weights-free
    (``shallow_logits``, weights drawn from ``generator``, a CPU
    generator seeded 0 by default)."""
    dtype = internal_dtype_of(internal_dtype)
    path = weights_path or find_local_weights()
    model = InceptionV3(features_list, shallow_logits=path is None)
    if path is not None:
        load_torch_weights(model, path)
    else:
        lecun_normal_(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    return model.to(device=resolve_device(device), dtype=dtype).eval()
