"""The port's CLIP and DINOv2 extractors (``eval/clip.py``, ``eval/dinov2.py``)
against the JAX package's (CPU, f32).

- CLIP: a tiny ViT (width 64, 2 layers, patch 16, grid 4: 64px) and a tiny
  ModifiedResNet (layers (1, 1, 1, 1), width 8, attention-pool grid 2:
  64px), state dicts in OpenAI's key schema drawn by the port's
  ``random_clip_state_dict`` from a hyperparameter entry added for the test
  (LayerNorm affine terms then perturbed, the ResNet's convolutions
  He-scaled), against the JAX package's
  ``CLIPExtractor(load_clip_state_dict(sd))``: rel-max 1e-4. The
  architecture of all nine official names inferred from their state dicts'
  shapes alone (meta tensors: nothing materialised) against OpenAI's
  published hyperparameters. The weights-free state dicts of
  ``clip-vit-b-32`` and ``clip-rn50`` bit for bit the JAX package's.
- DINOv2: ``dinov2-vit-s-14`` at depth 2 and a hand-made SwiGLU block (the
  giant's FFN at width 384), against ``DINOv2Extractor``: rel-max 1e-4; the
  positional-embedding interpolation from the checkpoints' 37x37 grid
  against ``_interpolate_pos_embed``; the weights-free state dict bit for
  bit the JAX package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import clip as jc
from fastfourierconvolution_tpu.eval import dinov2 as jd
from fastfourierconvolution_tpu_torch.eval import clip as tc
from fastfourierconvolution_tpu_torch.eval import dinov2 as td

RTOL = 1e-4
TINY_VIT = (16, 64, 2, 32, 64)  # patch, width, layers, embed, resolution
TINY_RN = ((1, 1, 1, 1), 8, 16, 64)  # layers, width, embed, resolution
# OpenAI's published hyperparameters (CLIP's model card and clip/model.py):
# ViT (patch, width, layers, heads, embed, resolution),
# ResNet (layers, width, heads, embed, resolution)
OFFICIAL = {
    "clip-rn50": ((3, 4, 6, 3), 64, 32, 1024, 224),
    "clip-rn101": ((3, 4, 23, 3), 64, 32, 512, 224),
    "clip-rn50x4": ((4, 6, 10, 6), 80, 40, 640, 288),
    "clip-rn50x16": ((6, 8, 18, 8), 96, 48, 768, 384),
    "clip-rn50x64": ((3, 15, 36, 10), 128, 64, 1024, 448),
    "clip-vit-b-32": (32, 768, 12, 12, 512, 224),
    "clip-vit-b-16": (16, 768, 12, 12, 512, 224),
    "clip-vit-l-14": (14, 1024, 24, 16, 768, 224),
    "clip-vit-l-14-336px": (14, 1024, 24, 16, 768, 336),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def tiny_clip_state_dict(kind, monkeypatch, seed=0):
    if kind == "vit":
        monkeypatch.setitem(tc.VIT_META, "tiny", TINY_VIT)
    else:
        monkeypatch.setitem(tc.RN_META, "tiny", TINY_RN)
    rng = np.random.RandomState(seed)
    sd = tc.random_clip_state_dict("tiny", rng)
    for k, v in sd.items():
        if ".ln_" in k:  # LayerNorms away from identity
            sd[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif v.ndim == 4 and kind == "resnet":  # He-scaled, so images stay apart
            sd[k] = (v * np.sqrt(2.0 / np.prod(v.shape[1:])) / v.std()).astype(np.float32)
    return sd


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_tiny_clip_matches_jax(kind, monkeypatch):
    sd = tiny_clip_state_dict(kind, monkeypatch)
    x = images(3, 48, 1)
    variables = jc.load_clip_state_dict(sd)
    ref = jax.jit(jc.CLIPExtractor(config=variables["config"]).apply)(
        {"params": variables["params"]}, jnp.asarray(x))["clip"]
    model = tc.create_clip_extractor(weights_path=sd, device="cpu")
    assert model.config["kind"] == kind and model.config["resolution"] == 64
    assert model.config["heads"] == variables["config"]["heads"]
    with torch.inference_mode():
        out = model(torch.from_numpy(x))["clip"]
    assert out.shape == (3, TINY_VIT[3] if kind == "vit" else TINY_RN[2])
    assert rel_max(out, ref) < RTOL and rel_max(out[0], out[1]) > 1e-3


@pytest.mark.parametrize("name", tc.CLIP_NAMES)
def test_config_of_every_official_name(name):
    meta = {k: torch.empty(s, device="meta") for k, s in tc.clip_state_dict_shapes(name).items()}
    config = tc.clip_config(meta)
    want = OFFICIAL[name]
    if name in tc.VIT_META:
        got = (config["patch_size"], config["width"], config["layers"], config["heads"],
               config["embed"], config["resolution"])
    else:
        got = (config["layers"], config["width"], config["heads"], config["embed"],
               config["resolution"])
    assert got == want
    with torch.device("meta"):
        model = tc.CLIPExtractor(config)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in meta.items() if k.startswith("visual.")}


@pytest.mark.parametrize("name", ["clip-vit-b-32", "clip-rn50"])
def test_weights_free_clip_is_the_jax_packages(name):
    ref = jc.random_clip_state_dict(name, np.random.RandomState(0))
    out = tc.random_clip_state_dict(name, np.random.RandomState(0))
    assert list(out) == list(ref)
    for k, v in ref.items():
        assert out[k].dtype == v.dtype and np.array_equal(out[k], v), k


def swiglu_state_dict(seed=2):
    """One DINOv2 block with the giant's fused SwiGLU FFN at width 384."""
    rng = np.random.RandomState(seed)
    sd = td.random_dinov2_state_dict("dinov2-vit-s-14", rng, depth_override=1)
    for k in [k for k in sd if ".mlp." in k]:
        del sd[k]
    hidden = 2 * 4 * 384 // 3
    for key, shape in (("w12.weight", (2 * hidden, 384)), ("w12.bias", (2 * hidden,)),
                       ("w3.weight", (384, hidden)), ("w3.bias", (384,))):
        sd[f"blocks.0.mlp.{key}"] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return sd


@pytest.mark.parametrize("case", ["s14-depth2", "swiglu"])
def test_dinov2_matches_jax(case):
    sd = (td.random_dinov2_state_dict("dinov2-vit-s-14", np.random.RandomState(1),
                                      depth_override=2) if case == "s14-depth2"
          else swiglu_state_dict())
    for k in sd:  # LayerNorms and LayerScales away from their inits
        if ".norm" in k or k.startswith("norm") or ".ls" in k:
            sd[k] = (sd[k] + np.random.RandomState(3).randn(*sd[k].shape) * 0.1).astype(
                np.float32)
    x = images(2, 40, 4)
    variables = jd.load_dinov2_state_dict(sd)
    ref = jax.jit(jd.DINOv2Extractor(config=variables["config"]).apply)(
        {"params": variables["params"]}, jnp.asarray(x))["dinov2"]
    model = td.create_dinov2_extractor(weights_path=sd, device="cpu")
    assert model.config["swiglu"] == (case == "swiglu")
    with torch.inference_mode():
        out = model(torch.from_numpy(x))["dinov2"]
    assert out.shape == (2, 384) and rel_max(out, ref) < RTOL


def test_pos_embed_interpolation_matches_jax():
    """A 518px checkpoint's 37x37 grid to the 224px eval grid, and a state
    dict holding it (and the ``mask_token`` eval never reads) loads."""
    pos = np.random.RandomState(5).randn(1, 37 * 37 + 1, 384).astype(np.float32)
    out = td.interpolate_pos_embed(torch.from_numpy(pos))
    ref = jd._interpolate_pos_embed(pos, td.GRID)
    assert out.shape == (1, td.GRID ** 2 + 1, 384)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    sd = td.random_dinov2_state_dict("dinov2-vit-s-14", np.random.RandomState(6),
                                     depth_override=1)
    sd["pos_embed"], sd["mask_token"] = pos, np.zeros((1, 384), np.float32)
    model = td.dinov2_from_state_dict(sd)
    np.testing.assert_allclose(model.pos_embed.detach().numpy(), ref, rtol=0, atol=1e-6)


def test_weights_free_dinov2_is_the_jax_packages_and_names_resolve():
    ref = jd.random_dinov2_state_dict("dinov2-vit-b-14", np.random.RandomState(0),
                                      depth_override=2)
    out = td.random_dinov2_state_dict("dinov2-vit-b-14", np.random.RandomState(0),
                                      depth_override=2)
    assert list(out) == list(ref)
    for k, v in ref.items():
        assert np.array_equal(out[k], v), k
    assert td.DINOV2_NAMES == jd.DINOV2_NAMES and tc.CLIP_NAMES == jc.CLIP_NAMES
    with pytest.raises(KeyError, match="unknown DINOv2"):
        td.random_dinov2_state_dict("dinov2-vit-h-14", np.random.RandomState(0))
    with pytest.raises(ValueError, match="only provides the 'clip'"):
        tc.create_clip_extractor(("fc2",), device="cpu")
