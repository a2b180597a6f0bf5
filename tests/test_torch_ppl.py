"""The port's PPL (``eval/ppl.py``) against the JAX package's (CPU, f32).

- The interpolations on seeded latents, zero rows (the lerp branch) and
  collinear ones included, within 1e-6; ``sample_random`` bit for bit.
- ``calculate_ppl`` on a stand-in generative model whose ``apply`` is one
  numpy function z -> uint8 shared by both packages, so that equal latents
  give the same image bytes: lerp's e1 is the same bits in both packages
  (slerp's sin and arccos differ in the last bits, which may flip a level),
  so these runs interpolate with lerp. Raw distances, mean and standard
  deviation within 1e-4 relative. The LPIPS weights are one seeded
  torchvision backbone and one set of toshas heads; the JAX similarity
  factory is replaced by its own converter on them, which is what its
  ``create_lpips`` returns when both files are given, without the flax init
  it would run first.
- A narrow bridged ``FFCGenerator`` in f32 (the FourierUnit's eval forward
  on the path): each package's generator through each package's PPL. The
  two generators' images may differ by one uint8 level, and with epsilon
  1e-4 one level in one pixel moves a distance by about LPIPS's response
  to it times 1e8, far beyond a float tolerance. So the distances are held
  to 1e-4 relative only on the pairs whose images are the same bytes in
  both packages, and those must be most of them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import lpips as jl
from fastfourierconvolution_tpu.eval import pipeline as JP
from fastfourierconvolution_tpu.eval import ppl as jppl
from fastfourierconvolution_tpu.eval import registry as jregistry
from fastfourierconvolution_tpu.models import FFCGenerator as JFFCGenerator
from fastfourierconvolution_tpu.models.ffc_gan import to_uint8 as jto_uint8
from fastfourierconvolution_tpu_torch import FFCGenerator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.eval import pipeline as P
from fastfourierconvolution_tpu_torch.eval import ppl as tppl
from test_torch_ffc import seeded_variables
from test_torch_lpips import seeded_lpips_heads, seeded_vgg16_state_dict

RTOL = 1e-4
Z, SIZE, CLASSES = 16, 32, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    """(heads file, torchvision backbone file) of the seeded weights."""
    root = tmp_path_factory.mktemp("lpips")
    heads, vgg = str(root / "lpips.pth"), str(root / "vgg16.pth")
    torch.save(seeded_lpips_heads(), heads)
    torch.save(seeded_vgg16_state_dict(classifier=False), vgg)
    return heads, vgg


@pytest.fixture
def jax_lpips_by_converter(monkeypatch):
    def factory(resize=64, lpips_weights=None, vgg_weights=None):
        assert lpips_weights and vgg_weights
        return jl.LPIPS(resize=resize), jl.load_lpips_torch_weights(lpips_weights, vgg_weights)

    monkeypatch.setitem(jregistry.SAMPLE_SIMILARITIES, "lpips-vgg16", factory)


def latents(n=64, d=Z, seed=0):
    """Seeded rows, with zero rows and collinear (same and opposite) pairs."""
    rng = np.random.RandomState(seed)
    a, b = rng.randn(n, d).astype(np.float32), rng.randn(n, d).astype(np.float32)
    a[0], b[1] = 0, 0
    b[2], b[3] = a[2], -a[3]
    return a, b


@pytest.mark.parametrize("name", ["lerp", "slerp_any", "slerp_unit"])
def test_interpolations_match_jax(name):
    a, b = latents()
    for t in (1e-4, 0.3):
        ref = np.asarray(jppl.INTERPOLATIONS[name](jnp.asarray(a), jnp.asarray(b), t))
        out = tppl.INTERPOLATIONS[name](torch.from_numpy(a), torch.from_numpy(b), t).numpy()
        assert np.isfinite(out).all() and np.abs(out - ref).max() <= 1e-6, (name, t)
    lerp = tppl.batch_lerp(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy()
    if name == "slerp_any":
        # the zero rows take the lerp branch; a collinear row's cosine may
        # round to just below 1 - eps in f32, where slerp is lerp to 1e-6
        np.testing.assert_array_equal(out[:2], lerp[:2])
        assert np.abs(out[2:4] - lerp[2:4]).max() <= 1e-6


@pytest.mark.parametrize("z_type", ["normal", "unit", "uniform_0_1"])
def test_sample_random_is_the_jax_packages(z_type):
    ref = jppl.sample_random(np.random.RandomState(5), (7, Z), z_type)
    out = tppl.sample_random(np.random.RandomState(5), (7, Z), z_type)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


_W = np.random.default_rng(11).standard_normal((Z, SIZE * SIZE * 3)).astype(np.float32) * 10
_LABEL_SHIFT = np.random.default_rng(12).standard_normal((CLASSES, SIZE * SIZE * 3)).astype(
    np.float32)


def stand_in(z, labels=None):
    """One numpy function z (, labels) -> uint8 (B, 32, 32, 3), steep enough
    that e1 = e0 + 1e-4 (e1' - e0) moves most pixels by a level or more: a
    distance then sums many changed features, not a few near-cancelling
    ones (where both packages' f32 rounding alone is 1e-4 of it)."""
    x = np.asarray(z, np.float32) @ _W
    if labels is not None:
        x = x + _LABEL_SHIFT[np.asarray(labels)]
    x = np.sin(x).reshape(-1, SIZE, SIZE, 3)
    return (255.0 * (x * 0.5 + 0.5)).astype(np.uint8)


def both_models(classes):
    return (JP.GenerativeModel(apply=stand_in, z_size=Z, num_classes=classes),
            P.GenerativeModel(apply=stand_in, z_size=Z, num_classes=classes))


def assert_same_ppl(out, ref, raw):
    keys = [tppl.KEY_PPL_MEAN, tppl.KEY_PPL_STD] + ([tppl.KEY_PPL_RAW] if raw else [])
    assert sorted(out) == sorted(ref) == sorted(keys)
    if raw:
        assert out[tppl.KEY_PPL_RAW].shape == ref[tppl.KEY_PPL_RAW].shape
        assert (ref[tppl.KEY_PPL_RAW] > 0).all()
        np.testing.assert_allclose(out[tppl.KEY_PPL_RAW], ref[tppl.KEY_PPL_RAW], rtol=RTOL)
    for k in keys[:2]:
        assert abs(out[k] - ref[k]) <= RTOL * abs(ref[k]), (k, out[k], ref[k])


@pytest.mark.parametrize("classes, reduction, discard", [
    (0, "none", True), (0, "mean", False), (CLASSES, "none", False), (CLASSES, "mean", True),
], ids=["uncond-none-filtered", "uncond-mean", "cond-none", "cond-mean-filtered"])
def test_calculate_ppl_matches_jax(classes, reduction, discard, lpips_files,
                                   jax_lpips_by_converter):
    heads, vgg = lpips_files
    jm, tm = both_models(classes)
    kw = dict(num_samples=12, batch_size=8, reduction=reduction, rng_seed=3,
              lpips_weights=heads, vgg_weights=vgg,
              # the default resize to 64 in one case, LPIPS at 32 in the others
              similarity_resize=64 if classes == 0 and discard else None,
              # 10/90: on 12 distances the 1st/99th percentiles drop none
              discard_percentile_lower=10.0 if discard else None,
              discard_percentile_higher=90.0 if discard else None)
    ref = jppl.calculate_ppl(jm, **kw)
    out = tppl.calculate_ppl(tm, **kw, device="cpu")
    assert_same_ppl(out, ref, raw=reduction == "none")
    if reduction == "none":
        assert len(out[tppl.KEY_PPL_RAW]) == (10 if discard else 12)


def test_calculate_metrics_ppl_matches_jax(lpips_files, jax_lpips_by_converter):
    heads, vgg = lpips_files
    jm, tm = both_models(0)
    kw = dict(ppl=True, input1_model_num_samples=12, batch_size=8, ppl_reduction="none",
              ppl_sample_similarity_resize=None, lpips_weights_path=heads,
              vgg_weights_path=vgg)
    ref = JP.calculate_metrics(jm, **kw)
    out = P.calculate_metrics(tm, **kw, device="cpu")
    assert_same_ppl(out, ref, raw=True)


def test_bad_arguments_raise():
    _, tm = both_models(0)
    with pytest.raises(KeyError, match="not registered"):
        tppl.calculate_ppl(tm, num_samples=4, similarity_name="lpips-alex", device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tppl.calculate_ppl(tm, num_samples=4, reduction="sum", device="cpu")
    with pytest.raises(ValueError, match="GenerativeModel"):
        P.calculate_metrics(np.zeros((4, 8, 8, 3), np.uint8), ppl=True, device="cpu")


NARROW = dict(z_size=Z, ngf=16, ratio_g=0.5, mg=4, channel_mults=(2, 1))  # 16px


def test_bridged_generator_ppl_matches_jax(lpips_files, jax_lpips_by_converter):
    """Each package's narrow FFCGenerator (f32, eval mode) through its own
    PPL, the same latents fed to both (checked), distances at 1e-4 relative
    on the pairs whose images are the same bytes."""
    heads, vgg = lpips_files
    jmodel = JFFCGenerator(**NARROW, packed=False)
    z0 = jnp.zeros((2, Z))
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jmodel.init(rngs, z, True), z0)
    variables = seeded_variables(shapes, seed=3)
    model = FFCGenerator(**NARROW, packed=False)
    model.load_state_dict(jax_to_state_dict(model, variables["params"],
                                            variables["batch_stats"]))
    model.eval()
    jgenerate = jax.jit(lambda z: jto_uint8(
        jmodel.apply(variables, z, False, rngs={"noise": jax.random.PRNGKey(0)})))
    seen = {"jax": [], "port": []}

    def japply(z):
        seen["jax"].append((np.asarray(z), np.asarray(jgenerate(z))))
        return seen["jax"][-1][1]

    def tapply(z):
        with torch.no_grad():
            x = model(z)
        img = (255.0 * (x.clamp(-1, 1) * 0.5 + 0.5)).to(torch.uint8).permute(0, 2, 3, 1)
        seen["port"].append((z.numpy(), img.numpy()))
        return img

    kw = dict(num_samples=16, batch_size=8, reduction="none", lpips_weights=heads,
              vgg_weights=vgg, discard_percentile_lower=None, discard_percentile_higher=None)
    ref = jppl.calculate_ppl(JP.GenerativeModel(apply=japply, z_size=Z), **kw)
    out = tppl.calculate_ppl(P.GenerativeModel(apply=tapply, z_size=Z), **kw, device="cpu")
    zs = {k: np.concatenate([z for z, _ in v]) for k, v in seen.items()}
    np.testing.assert_array_equal(zs["port"], zs["jax"])
    imgs = {k: np.concatenate([i for _, i in v]).astype(int) for k, v in seen.items()}
    assert imgs["jax"].std() > 2 and np.abs(imgs["port"] - imgs["jax"]).max() <= 1
    # calls alternate e0, e1 per batch of 8: pair p's images sit in both halves
    same = [(np.array_equal(imgs["port"][i], imgs["jax"][i]) and
             np.array_equal(imgs["port"][i + 8], imgs["jax"][i + 8]))
            for b in (0, 16) for i in range(b, b + 8)]
    assert sum(same) >= len(same) // 2, same
    d_out, d_ref = out[tppl.KEY_PPL_RAW], ref[tppl.KEY_PPL_RAW]
    np.testing.assert_allclose(d_out[same], d_ref[same], rtol=RTOL)
    assert np.isfinite(d_out).all() and (d_ref > 0).any()
