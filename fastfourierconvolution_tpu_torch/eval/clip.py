"""CLIP visual-tower feature extractors ("clip-rn50" ... "clip-vit-l-14-336px"),
the JAX package's ``eval/clip.py``.

Both of OpenAI's visual towers, with OpenAI's ``visual.*`` parameter names,
NCHW inside the network:

  * ModifiedResNet (rn50, rn101, rn50x4, rn50x16, rn50x64): a 3-convolution
    stem and a 2x2 average pool, bottlenecks that average-pool before
    their strided step (the convolution path after its 3x3, the
    downsample path before its 1x1), and an attention pool over
    [mean; HW] tokens whose query is the mean token alone;
  * VisionTransformer (vit-b-32, vit-b-16, vit-l-14, vit-l-14-336px): the
    patch convolution, class token, positional embedding, ``ln_pre``,
    pre-LN blocks with QuickGELU MLPs, ``ln_post`` on the class token,
    then ``proj``.

LayerNorm and BatchNorm eps 1e-5. Attention is written out in the
network's dtype as ``softmax(Q K^T / sqrt(d)) V``, as the JAX package has
it. Input contract: uint8 (B, H, W, 3), cast to the network's dtype,
TF1-exact bilinear resize to the model's resolution, CLIP's 255-scaled
normalisation; the output is the 'clip' feature, float32.

As OpenAI's ``build_model``, the architecture comes from the state dict
(``clip_config``: heads = width // 64 for ViT, width * 32 // 64 for the
ResNet; the resolution from the positional-embedding grid), so one loader
serves all nine names: ``torch.load`` of a state dict, else
``torch.jit.load(...).state_dict()`` of OpenAI's ``.pt`` archive. The
official fp16 weights load into float32 exactly. Nothing is downloaded:
without a file the extractor is weights-free, built from
``random_clip_state_dict`` (a numpy copy of the JAX package's, so the two
packages' weights-free CLIPs are the same net).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.policy import resolve_device
from .inception import FrozenBatchNorm, internal_dtype_of
from .resize import resize_bilinear_tf1

CLIP_NAMES = (
    "clip-rn50",
    "clip-rn101",
    "clip-rn50x4",
    "clip-rn50x16",
    "clip-rn50x64",
    "clip-vit-b-32",
    "clip-vit-b-16",
    "clip-vit-l-14",
    "clip-vit-l-14-336px",
)
# the official hyperparameters: ViT (patch, width, layers, embed, resolution),
# ResNet (layers, width, embed, resolution)
VIT_META = {
    "clip-vit-b-32": (32, 768, 12, 512, 224),
    "clip-vit-b-16": (16, 768, 12, 512, 224),
    "clip-vit-l-14": (14, 1024, 24, 768, 224),
    "clip-vit-l-14-336px": (14, 1024, 24, 768, 336),
}
RN_META = {
    "clip-rn50": ((3, 4, 6, 3), 64, 1024, 224),
    "clip-rn101": ((3, 4, 23, 3), 64, 512, 224),
    "clip-rn50x4": ((4, 6, 10, 6), 80, 640, 288),
    "clip-rn50x16": ((6, 8, 18, 8), 96, 768, 384),
    "clip-rn50x64": ((3, 15, 36, 10), 128, 1024, 448),
}
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32) * 255.0
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32) * 255.0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head ``softmax(Q K^T / sqrt(d)) V`` over (B, L, D) projections."""
    b, lq, d = q.shape
    hd = d // num_heads
    q = q.reshape(b, lq, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, k.shape[1], num_heads, hd).transpose(1, 2)
    v = v.reshape(b, v.shape[1], num_heads, hd).transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, lq, d)


# --- ModifiedResNet -----------------------------------------------------------------------


class _Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4, eps=1e-5)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            # OpenAI's downsample Sequential: "-1" (AvgPool2d), "0" (conv), "1" (bn)
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False))
            self.downsample.add_module("1", FrozenBatchNorm(planes * 4, eps=1e-5))

    def _pool(self, x):
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self._pool(out)))
        identity = x if self.downsample is None else self.downsample(self._pool(x))
        return F.relu(out + identity)


class _AttentionPool(nn.Module):
    def __init__(self, grid: int, dim: int, heads: int, out_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, dim))
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.c_proj = nn.Linear(dim, out_dim)

    def forward(self, x):
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C), h-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        out = attention(self.q_proj(tokens[:, :1]), self.k_proj(tokens), self.v_proj(tokens),
                        self.heads)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Sequence[int], width: int, heads: int, embed: int,
                 resolution: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(width // 2, eps=1e-5)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(width // 2, eps=1e-5)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm(width, eps=1e-5)
        inplanes = width
        for li, n in enumerate(layers):
            planes = width * 2 ** li
            blocks = []
            for bi in range(n):
                blocks.append(_Bottleneck(inplanes, planes, 2 if li and not bi else 1))
                inplanes = planes * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.attnpool = _AttentionPool(resolution // 32, width * 32, heads, embed)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.avg_pool2d(F.relu(self.bn3(self.conv3(x))), 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


# --- VisionTransformer --------------------------------------------------------------------


class _SelfAttention(nn.Module):
    """torch MultiheadAttention's parameters (fused ``in_proj``, ``out_proj``),
    the attention written out."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads))


class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = _SelfAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", _QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(*[_ResidualBlock(width, heads) for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int, width: int, layers: int, heads: int, embed: int,
                 resolution: int):
        super().__init__()
        grid = resolution // patch_size
        self.patch_size = patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, embed))

    def forward(self, x):
        x = self.conv1(x).flatten(2).transpose(1, 2)  # (B, g*g, W), h-major
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.transformer(x)
        return self.ln_post(x[:, 0]) @ self.proj


# --- the extractor ------------------------------------------------------------------------


def check_features(features_list, feature: str = "clip") -> None:
    """Raise unless ``features_list`` asks for ``feature`` alone (the CLIP
    and DINOv2 extractors provide one feature each)."""
    if tuple(features_list) != (feature,):
        raise ValueError(f"this extractor only provides the '{feature}' feature, got "
                         f"{tuple(features_list)}")


class CLIPExtractor(nn.Module):
    """``forward(uint8 (B, H, W, 3)) -> {'clip': (B, embed)}``; ``config`` as
    ``clip_config`` gives it. Computes in the parameters' dtype."""

    def __init__(self, config: Dict, features_list: Sequence[str] = ("clip",)):
        super().__init__()
        check_features(features_list)
        self.features_list = ("clip",)
        self.config = dict(config)
        c = self.config
        if c["kind"] == "vit":
            self.visual = VisionTransformer(c["patch_size"], c["width"], c["layers"], c["heads"],
                                            c["embed"], c["resolution"])
        else:
            self.visual = ModifiedResNet(c["layers"], c["width"], c["heads"], c["embed"],
                                         c["resolution"])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"CLIP takes uint8 (B, H, W, 3) images, got {x.dtype} "
                             f"{tuple(x.shape)}")
        dtype = self.visual.conv1.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        res = self.config["resolution"]
        x = resize_bilinear_tf1(x, (res, res), align_corners=False, layout="NCHW")
        mean = torch.from_numpy(_MEAN).to(x).view(1, 3, 1, 1)
        std = torch.from_numpy(_STD).to(x).view(1, 3, 1, 1)
        return {"clip": self.visual((x - mean) / std).float()}


def clip_config(sd) -> Dict:
    """The architecture of an OpenAI CLIP state dict (or its ``visual.*``
    part), from the shapes alone, as OpenAI's ``build_model`` infers it."""
    shape = lambda k: tuple(sd[k].shape)
    if "visual.proj" in sd:
        width, _, patch, _ = shape("visual.conv1.weight")
        grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        layers = len([k for k in sd if k.startswith("visual.")
                      and k.endswith(".attn.in_proj_weight")])
        return {"kind": "vit", "width": width, "layers": layers, "patch_size": patch,
                "heads": width // 64, "embed": shape("visual.proj")[1],
                "resolution": patch * grid}
    counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
                   for b in (1, 2, 3, 4))
    width = shape("visual.layer1.0.conv1.weight")[0]
    grid = round((shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5)
    return {"kind": "resnet", "layers": counts, "width": width, "heads": width * 32 // 64,
            "embed": shape("visual.attnpool.c_proj.weight")[0], "resolution": grid * 32}


def load_clip_torch_weights(path_or_dict):
    """An OpenAI CLIP state dict: the dict itself, a ``torch.save`` file, or
    OpenAI's TorchScript ``.pt`` archive. Returns the dict."""
    if not isinstance(path_or_dict, (str, bytes)):
        return path_or_dict
    try:
        return torch.load(path_or_dict, map_location="cpu", weights_only=True)
    except Exception:
        return torch.jit.load(path_or_dict, map_location="cpu").state_dict()


def clip_from_state_dict(sd, features_list: Sequence[str] = ("clip",)) -> CLIPExtractor:
    """The extractor of ``sd``'s architecture with its ``visual.*`` weights,
    loaded strictly (``num_batches_tracked`` dropped), float32, on the CPU."""
    model = CLIPExtractor(clip_config(sd), features_list)
    state = {k: torch.as_tensor(v) for k, v in sd.items()
             if k.startswith("visual.") and not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=True)
    return model


# --- the weights-free state dict ----------------------------------------------------------


def _clip_schema(name: str) -> Iterator[Tuple[str, tuple, str, float]]:
    """(key, shape, init, scale) of ``name``'s state dict, in the order the
    JAX package's ``random_clip_state_dict`` draws them. init: 'normal'
    (randn * scale), 'ones', 'zeros', 'bn' (four entries from one key
    prefix: weight uniform(0.5, 1.5), bias, running_mean randn * 0.1,
    running_var uniform(0.5, 1.5))."""
    if name in VIT_META:
        patch, width, layers, embed, res = VIT_META[name]
        grid = res // patch
        yield "visual.conv1.weight", (width, 3, patch, patch), "normal", 0.02
        yield "visual.class_embedding", (width,), "normal", 0.02
        yield "visual.positional_embedding", (grid * grid + 1, width), "normal", 0.02
        for p in ("visual.ln_pre", "visual.ln_post"):
            yield f"{p}.weight", (width,), "ones", 0
            yield f"{p}.bias", (width,), "zeros", 0
        yield "visual.proj", (width, embed), "normal", 0.02
        for i in range(layers):
            b = f"visual.transformer.resblocks.{i}"
            yield f"{b}.attn.in_proj_weight", (3 * width, width), "normal", 0.02
            yield f"{b}.attn.in_proj_bias", (3 * width,), "normal", 0.02
            yield f"{b}.attn.out_proj.weight", (width, width), "normal", 0.02
            yield f"{b}.attn.out_proj.bias", (width,), "normal", 0.02
            for p in (f"{b}.ln_1", f"{b}.ln_2"):
                yield f"{p}.weight", (width,), "ones", 0
                yield f"{p}.bias", (width,), "zeros", 0
            yield f"{b}.mlp.c_fc.weight", (4 * width, width), "normal", 0.02
            yield f"{b}.mlp.c_fc.bias", (4 * width,), "normal", 0.02
            yield f"{b}.mlp.c_proj.weight", (width, 4 * width), "normal", 0.02
            yield f"{b}.mlp.c_proj.bias", (width,), "normal", 0.02
    else:
        layers, width, embed, res = RN_META[name]
        yield "visual.conv1.weight", (width // 2, 3, 3, 3), "normal", 0.1
        yield "visual.bn1", (width // 2,), "bn", 0
        yield "visual.conv2.weight", (width // 2, width // 2, 3, 3), "normal", 0.05
        yield "visual.bn2", (width // 2,), "bn", 0
        yield "visual.conv3.weight", (width, width // 2, 3, 3), "normal", 0.05
        yield "visual.bn3", (width,), "bn", 0
        inplanes = width
        for li, nblocks in enumerate(layers):
            planes = width * 2 ** li
            for bi in range(nblocks):
                b = f"visual.layer{li + 1}.{bi}"
                yield f"{b}.conv1.weight", (planes, inplanes, 1, 1), "normal", 0.05
                yield f"{b}.bn1", (planes,), "bn", 0
                yield f"{b}.conv2.weight", (planes, planes, 3, 3), "normal", 0.05
                yield f"{b}.bn2", (planes,), "bn", 0
                yield f"{b}.conv3.weight", (planes * 4, planes, 1, 1), "normal", 0.05
                yield f"{b}.bn3", (planes * 4,), "bn", 0
                if bi == 0 and (li > 0 or inplanes != planes * 4):
                    yield f"{b}.downsample.0.weight", (planes * 4, inplanes, 1, 1), "normal", 0.05
                    yield f"{b}.downsample.1", (planes * 4,), "bn", 0
                inplanes = planes * 4
        emb_dim, grid = width * 32, res // 32
        yield ("visual.attnpool.positional_embedding", (grid * grid + 1, emb_dim), "normal",
               emb_dim ** -0.5)
        for pr in ("q_proj", "k_proj", "v_proj"):
            yield f"visual.attnpool.{pr}.weight", (emb_dim, emb_dim), "normal", 0.02
            yield f"visual.attnpool.{pr}.bias", (emb_dim,), "normal", 0.02
        yield "visual.attnpool.c_proj.weight", (embed, emb_dim), "normal", 0.02
        yield "visual.attnpool.c_proj.bias", (embed,), "normal", 0.02
    yield "text_projection", (1, embed), "zeros", 0


def clip_state_dict_shapes(name: str) -> Dict[str, tuple]:
    """The shapes of ``name``'s state dict, with nothing drawn."""
    shapes = {}
    for key, shape, init, _ in _clip_schema(name):
        for k in ([f"{key}.{leaf}" for leaf in ("weight", "bias", "running_mean", "running_var")]
                  if init == "bn" else [key]):
            shapes[k] = shape
    return shapes


def random_clip_state_dict(name: str, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """A seeded state dict with the official hyperparameters of ``name``,
    fp16-representable like the official checkpoints: the JAX package's
    ``random_clip_state_dict``, draw for draw."""
    if name not in VIT_META and name not in RN_META:
        raise KeyError(f"unknown CLIP model {name!r}; known: {CLIP_NAMES}")
    q = lambda v: v.astype(np.float32).astype(np.float16).astype(np.float32)
    sd: Dict[str, np.ndarray] = {}
    for key, shape, init, scale in _clip_schema(name):
        if init == "normal":
            sd[key] = q((rng.randn(*shape) * scale).astype(np.float32))
        elif init == "ones":
            sd[key] = np.ones(shape, np.float32)
        elif init == "zeros":
            sd[key] = np.zeros(shape, np.float32)
        else:
            sd[f"{key}.weight"] = q(rng.uniform(0.5, 1.5, shape).astype(np.float32))
            sd[f"{key}.bias"] = q((rng.randn(*shape) * 0.1).astype(np.float32))
            sd[f"{key}.running_mean"] = q((rng.randn(*shape) * 0.1).astype(np.float32))
            sd[f"{key}.running_var"] = q(rng.uniform(0.5, 1.5, shape).astype(np.float32))
    return sd


def create_clip_extractor(features_list: Sequence[str] = ("clip",),
                          weights_path: Optional[str] = None, name: str = "clip-vit-b-32",
                          rng: Optional[np.random.RandomState] = None,
                          internal_dtype: Optional[str] = None, device="cuda") -> CLIPExtractor:
    """The extractor in eval mode on ``device``, in ``internal_dtype``: the
    weights of ``weights_path`` (whose architecture wins over ``name``),
    else weights-free from ``random_clip_state_dict(name, rng)`` (seed 0 by
    default)."""
    dtype = internal_dtype_of(internal_dtype)
    check_features(features_list)
    sd = (load_clip_torch_weights(weights_path) if weights_path is not None
          else random_clip_state_dict(name, rng or np.random.RandomState(0)))
    model = clip_from_state_dict(sd, features_list)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
