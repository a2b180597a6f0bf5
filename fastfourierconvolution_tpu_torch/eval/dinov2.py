"""DINOv2 ViT feature extractors ("dinov2-vit-s-14" ... "dinov2-vit-g-14"), the
JAX package's ``eval/dinov2.py``.

The facebookresearch/dinov2 ViT, with its parameter names: the patch-14
convolution, class token and positional embedding, pre-LN blocks (eps
1e-6) with LayerScale on both branches, an MLP with exact GELU (s, b, l) or
a fused SwiGLU where the state dict holds ``mlp.w12`` / ``mlp.w3`` (g),
the final LayerNorm, the class token out (s 384, b 768, l 1024, g 1536
wide). Attention is written out as ``softmax(Q K^T / sqrt(d)) V``.

Input contract (torch-fidelity's feature_extractor_dinov2.py): uint8
(B, H, W, 3), cast to the network's dtype, TF1-exact bilinear resize to
224, the 255-scaled torchvision normalisation; the output is the 'dinov2'
feature, float32.

The official checkpoints hold the 518px training grid (37x37); the 224px
eval grid (16x16) is interpolated from it once, at load, as the hub model
does at run time (bicubic, ``antialias=False``, scale (grid + 0.1) / M).
``mask_token``, which eval never reads, is dropped on load. Nothing goes
through ``torch.hub`` and nothing is downloaded: without a file the
extractor is weights-free, built from ``random_dinov2_state_dict`` (a numpy
copy of the JAX package's: the same net).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.policy import resolve_device
from .clip import attention, check_features
from .inception import internal_dtype_of
from .resize import resize_bilinear_tf1

DINOV2_NAMES = (
    "dinov2-vit-s-14",
    "dinov2-vit-b-14",
    "dinov2-vit-l-14",
    "dinov2-vit-g-14",
)
# name: (dim, depth, heads, swiglu)
DINOV2_META = {
    "dinov2-vit-s-14": (384, 12, 6, False),
    "dinov2-vit-b-14": (768, 12, 12, False),
    "dinov2-vit-l-14": (1024, 24, 16, False),
    "dinov2-vit-g-14": (1536, 40, 24, True),
}
HEADS_OF_DIM = {384: 6, 768: 12, 1024: 16, 1536: 24}
INPUT_IMAGE_SIZE = 224
PATCH = 14
GRID = INPUT_IMAGE_SIZE // PATCH
_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(attention(q, k, v, self.heads))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: nn.Module):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = mlp
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2Extractor(nn.Module):
    """``forward(uint8 (B, H, W, 3)) -> {'dinov2': (B, dim)}``; ``config`` as
    ``dinov2_config`` gives it. Computes in the parameters' dtype."""

    def __init__(self, config: Dict, features_list: Sequence[str] = ("dinov2",)):
        super().__init__()
        check_features(features_list, "dinov2")
        self.features_list = ("dinov2",)
        self.config = dict(config)
        dim, heads, hidden = config["dim"], config["heads"], config["hidden"]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, GRID * GRID + 1, dim))
        self.patch_embed = _PatchEmbed(dim)
        mlp = _SwiGLU if config["swiglu"] else _Mlp
        self.blocks = nn.ModuleList([_Block(dim, heads, mlp(dim, hidden))
                                     for _ in range(config["depth"])])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"DINOv2 takes uint8 (B, H, W, 3) images, got {x.dtype} "
                             f"{tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2).to(self.cls_token.dtype)
        x = resize_bilinear_tf1(x, (INPUT_IMAGE_SIZE, INPUT_IMAGE_SIZE), align_corners=False,
                                layout="NCHW")
        mean = torch.from_numpy(_MEAN).to(x).view(1, 3, 1, 1)
        std = torch.from_numpy(_STD).to(x).view(1, 3, 1, 1)
        x = self.patch_embed.proj((x - mean) / std).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return {"dinov2": self.norm(x)[:, 0].float()}


def dinov2_config(sd) -> Dict:
    """The architecture of a facebookresearch/dinov2 backbone state dict,
    from the shapes alone."""
    dim = sd["cls_token"].shape[-1]
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    swiglu = "blocks.0.mlp.w12.weight" in sd
    hidden = (sd["blocks.0.mlp.w3.weight"].shape[1] if swiglu
              else sd["blocks.0.mlp.fc1.weight"].shape[0])
    return {"dim": dim, "depth": depth, "heads": HEADS_OF_DIM[dim], "swiglu": swiglu,
            "hidden": hidden}


def interpolate_pos_embed(pos: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` for a fixed grid: the patch
    positions of a (1, 1 + M*M, D) embedding resized bicubically
    (``antialias=False``) by the scale (grid + 0.1) / M; the class position
    as it is."""
    m = int(round(math.sqrt(pos.shape[1] - 1)))
    if m == grid:
        return pos
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    dim = pos.shape[-1]
    t = patch_pos.float().reshape(1, m, m, dim).permute(0, 3, 1, 2)
    scale = float(grid + 0.1) / m
    t = F.interpolate(t, scale_factor=(scale, scale), mode="bicubic", antialias=False)
    if t.shape[-1] != grid:
        raise ValueError(f"pos_embed grid {m} does not interpolate to {grid}: {tuple(t.shape)}")
    return torch.cat([cls_pos.float(), t.permute(0, 2, 3, 1).reshape(1, grid * grid, dim)], 1)


def load_dinov2_torch_weights(path_or_dict):
    """A facebookresearch/dinov2 backbone state dict: the dict itself or a
    ``torch.save`` file. Returns the dict."""
    if not isinstance(path_or_dict, (str, bytes)):
        return path_or_dict
    return torch.load(path_or_dict, map_location="cpu", weights_only=True)


def dinov2_from_state_dict(sd, features_list: Sequence[str] = ("dinov2",)) -> DINOv2Extractor:
    """The extractor of ``sd``'s architecture with its weights, loaded
    strictly (``mask_token`` dropped, ``pos_embed`` interpolated to the 224px
    grid), float32, on the CPU."""
    model = DINOv2Extractor(dinov2_config(sd), features_list)
    state = {k: torch.as_tensor(v) for k, v in sd.items() if k != "mask_token"}
    state["pos_embed"] = interpolate_pos_embed(state["pos_embed"])
    model.load_state_dict(state, strict=True)
    return model


def random_dinov2_state_dict(name: str, rng: np.random.RandomState,
                             depth_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A seeded state dict in the official key schema at the 224px grid:
    the JAX package's ``random_dinov2_state_dict``, draw for draw."""
    if name not in DINOV2_META:
        raise KeyError(f"unknown DINOv2 model {name!r}; known: {DINOV2_NAMES}")
    dim, depth, _, swiglu = DINOV2_META[name]
    depth = depth_override or depth
    sd: Dict[str, np.ndarray] = {}

    def put(key, *shape, scale=0.02):
        sd[key] = (rng.randn(*shape) * scale).astype(np.float32)

    put("cls_token", 1, 1, dim)
    put("pos_embed", 1, GRID * GRID + 1, dim)
    put("patch_embed.proj.weight", dim, 3, PATCH, PATCH, scale=0.05)
    put("patch_embed.proj.bias", dim)
    sd["norm.weight"] = np.ones((dim,), np.float32)
    sd["norm.bias"] = np.zeros((dim,), np.float32)
    hidden = 4 * dim
    for i in range(depth):
        b = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{b}.{nm}.weight"] = np.ones((dim,), np.float32)
            sd[f"{b}.{nm}.bias"] = np.zeros((dim,), np.float32)
        put(f"{b}.attn.qkv.weight", 3 * dim, dim)
        put(f"{b}.attn.qkv.bias", 3 * dim)
        put(f"{b}.attn.proj.weight", dim, dim)
        put(f"{b}.attn.proj.bias", dim)
        sd[f"{b}.ls1.gamma"] = np.full((dim,), 0.5, np.float32)
        sd[f"{b}.ls2.gamma"] = np.full((dim,), 0.5, np.float32)
        if swiglu:
            sw_hidden = 4096 if dim == 1536 else (2 * hidden) // 3
            put(f"{b}.mlp.w12.weight", 2 * sw_hidden, dim)
            put(f"{b}.mlp.w12.bias", 2 * sw_hidden)
            put(f"{b}.mlp.w3.weight", dim, sw_hidden)
            put(f"{b}.mlp.w3.bias", dim)
        else:
            put(f"{b}.mlp.fc1.weight", hidden, dim)
            put(f"{b}.mlp.fc1.bias", hidden)
            put(f"{b}.mlp.fc2.weight", dim, hidden)
            put(f"{b}.mlp.fc2.bias", dim)
    return sd


def create_dinov2_extractor(features_list: Sequence[str] = ("dinov2",),
                            weights_path: Optional[str] = None, name: str = "dinov2-vit-s-14",
                            rng: Optional[np.random.RandomState] = None,
                            internal_dtype: Optional[str] = None,
                            device="cuda") -> DINOv2Extractor:
    """The extractor in eval mode on ``device``, in ``internal_dtype``: the
    weights of ``weights_path`` (whose architecture wins over ``name``),
    else weights-free from ``random_dinov2_state_dict(name, rng)`` (seed 0
    by default)."""
    dtype = internal_dtype_of(internal_dtype)
    check_features(features_list, "dinov2")
    sd = (load_dinov2_torch_weights(weights_path) if weights_path is not None
          else random_dinov2_state_dict(name, rng or np.random.RandomState(0)))
    model = dinov2_from_state_dict(sd, features_list)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
