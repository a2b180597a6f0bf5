"""The port's VGG16 extractor and LPIPS (``eval/lpips.py``) against the JAX
package's (CPU, f32).

One seeded state dict in the upstream schemas feeds both packages (the JAX
one through its converters ``load_vgg16_torch_weights`` /
``load_lpips_torch_weights``, the port through its strict loaders):
torchvision's vgg16 (He-normal convolutions and linears, so that the deep
features keep images apart; ``classifier.6`` included, which the port drops)
and the toshas LPIPS heads (uniform in [0, 0.1)). Tolerances: every VGG16
tap and feature within 1e-4 of its largest value (rel-max; the two packages
sum each convolution in another order, about 1e-6 apart), LPIPS distances
within 1e-4 relative, identical images at distance 0. The bridge inverts
the JAX converters exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import lpips as jl
from fastfourierconvolution_tpu_torch.bridge import (
    lpips_variables_to_state_dict,
    vgg16_variables_to_state_dict,
)
from fastfourierconvolution_tpu_torch.eval import lpips as tl

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_vgg16_state_dict(seed: int = 0, classifier: bool = True) -> dict:
    """A torchvision-layout vgg16 state dict: He-normal weights (std
    sqrt(2 / fan_in)), biases normal(0, 0.01); ``classifier`` adds the three
    linears (fc0 alone is 25088 x 4096, 411 MB)."""
    rng = np.random.default_rng(seed)
    shapes, cin = {}, 3
    convs = iter(tl.TORCH_CONV_IDX)
    for cout, n in tl.VGG_PLAN:
        for _ in range(n):
            i = next(convs)
            shapes[f"features.{i}.weight"] = (cout, cin, 3, 3)
            shapes[f"features.{i}.bias"] = (cout,)
            cin = cout
    if classifier:
        for i, (fo, fi) in ((0, (4096, 25088)), (3, (4096, 4096)), (6, (1000, 4096))):
            shapes[f"classifier.{i}.weight"] = (fo, fi)
            shapes[f"classifier.{i}.bias"] = (fo,)
    state = {}
    for name, shape in shapes.items():
        if name.endswith("weight"):
            v = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                np.sqrt(2.0 / np.prod(shape[1:])))
        else:
            v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.01)
        state[name] = torch.from_numpy(v)
    return state


def seeded_lpips_heads(seed: int = 1) -> dict:
    """The toshas LPIPS heads' layout, ``lin{i}.model.1.weight`` (1, C, 1, 1),
    uniform in [0, 0.1)."""
    rng = np.random.default_rng(seed)
    return {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(tl.LPIPS_CHANNELS)}


def images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def features_state():
    return seeded_vgg16_state_dict(classifier=False)


@pytest.fixture(scope="module")
def full_vgg16_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg16") / "vgg16.pth"
    torch.save(seeded_vgg16_state_dict(), path)
    return str(path)


def test_vgg16_features_taps_match_jax(features_state):
    """The five taps on 64x64 inputs, the LPIPS path (normalised float
    input): the JAX module applied to the converted parameters."""
    x = (images(2, 64, 0).astype(np.float32) - 127.5) / 64.0
    params = jl._convert_vgg_features(features_state)
    ref = jax.jit(jl.VGG16Features().apply)({"params": params}, jnp.asarray(x))
    net = tl.VGG16Features()
    net.load_state_dict({k[len("features."):]: v for k, v in features_state.items()})
    with torch.inference_mode():
        out = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(out) == len(ref) == 5
    for o, r, c in zip(out, ref, tl.LPIPS_CHANNELS):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert o.shape == r.shape and o.shape[1] == c
        assert np.abs(r).max() > 0 and rel_max(o, r) < RTOL


def test_full_vgg16_from_a_torchvision_file_matches_jax(full_vgg16_file):
    """The torchvision file through both packages' loaders, fc2 and fc2_relu
    on 2 images at the full size (224 after the resize); the bridge takes
    the JAX variables back to the file's own tensors."""
    x = images(2, 40, 1)
    variables = jl.load_vgg16_torch_weights(full_vgg16_file)
    ref = jax.jit(jl.VGG16(features_list=("fc2", "fc2_relu")).apply)(variables, jnp.asarray(x))
    model = tl.create_vgg16(("fc2", "fc2_relu"), weights_path=full_vgg16_file, device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert sorted(out) == ["fc2", "fc2_relu"]
    for k in out:
        assert out[k].shape == (2, 4096) and out[k].dtype == torch.float32
        assert rel_max(out[k], ref[k]) < RTOL, k
    assert (out["fc2_relu"] >= 0).all() and (out["fc2"] < 0).any()
    assert rel_max(out["fc2_relu"][0], out["fc2_relu"][1]) > 0.1  # images kept apart
    bridged = vgg16_variables_to_state_dict(jax.device_get(variables))
    for name, value in model.state_dict().items():
        assert torch.equal(bridged[name], value), name


@pytest.mark.parametrize("size", [None, 96, 32], ids=["no-resize", "area-96", "bilinear-32"])
def test_lpips_distances_match_jax(size, features_state):
    """Four pairs at ``resize=None`` (64px inputs), at 64 from 96 (area) and
    at 64 from 32 (bilinear), with the seeded heads and backbone."""
    heads = seeded_lpips_heads()
    resize = None if size is None else 64
    n = 64 if size is None else size
    x0 = images(4, n, 2).astype(np.float32)
    x1 = images(4, n, 3).astype(np.float32)
    variables = jl.load_lpips_torch_weights(heads, features_state)
    ref = np.asarray(jax.jit(jl.LPIPS(resize=resize).apply)(variables, x0, x1))
    model = tl.create_lpips(resize, lpips_weights=heads, vgg_weights=features_state,
                            device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
        same = model(torch.from_numpy(x0), torch.from_numpy(x0)).numpy()
    assert out.shape == (4,) and (ref > 0).all()
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).min(), (out, ref)
    assert (same == 0).all()


def test_the_bridge_inverts_the_jax_converter(features_state):
    """``lpips_variables_to_state_dict`` of the JAX variables converted from
    the seeded heads and backbone gives those tensors back."""
    heads = seeded_lpips_heads()
    bridged = lpips_variables_to_state_dict(
        jax.device_get(jl.load_lpips_torch_weights(heads, features_state)))
    model = tl.LPIPS(64)
    model.load_state_dict(bridged, strict=True)
    want = {**heads, **{"net." + k[len("features."):]: v for k, v in features_state.items()}}
    assert sorted(bridged) == sorted(want)
    for name, value in want.items():
        assert torch.equal(bridged[name], value), name


def test_weights_files_load_through_both_packages(tmp_path, features_state, monkeypatch):
    """A toshas-schema heads file and a torchvision-schema file written with
    ``torch.save``: JAX's ``load_lpips_torch_weights`` on the paths and the
    port's ``create_lpips`` finding them through ``$FFC_TPU_LPIPS_WEIGHTS``
    and ``$FFC_TPU_VGG16_WEIGHTS`` give the same distances; the port's
    strict loaders refuse a file missing a head."""
    heads, vgg = str(tmp_path / "lpips.pth"), str(tmp_path / "vgg16.pth")
    torch.save(seeded_lpips_heads(seed=7), heads)
    torch.save(features_state, vgg)
    monkeypatch.setenv("FFC_TPU_LPIPS_WEIGHTS", heads)
    monkeypatch.setenv("FFC_TPU_VGG16_WEIGHTS", vgg)
    x0, x1 = images(2, 64, 6).astype(np.float32), images(2, 64, 7).astype(np.float32)
    variables = jl.load_lpips_torch_weights(heads, vgg)
    ref = np.asarray(jax.jit(jl.LPIPS(resize=64).apply)(variables, x0, x1))
    with torch.inference_mode():
        out = tl.create_lpips(64, device="cpu")(torch.from_numpy(x0),
                                                torch.from_numpy(x1)).numpy()
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).min(), (out, ref)
    partial = {k: v for k, v in seeded_lpips_heads().items() if not k.startswith("lin4")}
    with pytest.raises(KeyError, match="lin4"):
        tl.load_lpips_torch_weights(tl.LPIPS(), partial)


def test_weights_free_nets_are_seeded_and_refuse_bad_inputs(monkeypatch):
    """Without files: the same weights-free VGG16 every time (seed 0), its
    features finite; the extractors' input contract."""
    monkeypatch.delenv("FFC_TPU_VGG16_WEIGHTS", raising=False)
    monkeypatch.delenv("FFC_TPU_LPIPS_WEIGHTS", raising=False)
    a, b = tl.create_lpips(device="cpu"), tl.create_lpips(device="cpu")
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    x = torch.from_numpy(images(2, 32, 8))
    with torch.inference_mode():
        d = a(x, x.flip(0))
    assert torch.isfinite(d).all() and (d > 0).all()
    with pytest.raises(ValueError, match="uint8"):
        tl.VGG16()(x.float())
    with pytest.raises(ValueError, match="features_list"):
        tl.VGG16(("fc1",))
