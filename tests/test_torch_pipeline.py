"""The port's metric pipeline (``eval/pipeline.py``) on the CPU.

- Against the JAX package: ``calculate_metrics`` with ISC, FID and KID on
  the same uint8 arrays and the same seeded torch-fidelity-layout weights
  file, within 1e-3 relative (the features agree to about 1e-6; FID reads
  the '768' tap, whose 768x768 eigenproblem costs a tenth of the 2048 one);
  and the requests of VGG16, LPIPS, CLIP and DINOv2: PRC under the default
  extractors alone and beside ISC (the dual split), PPL, FID on VGG16, ISC
  on a CLIP ViT and KID on a DINOv2 ViT, on seeded weights files in the
  upstream schemas, within 1e-3 relative.
- The port alone, weights-free (no InceptionV3 file in reach): the FID-only
  statistics shortcut and the on-disk cache (atomic files, reused, under
  the port's own cache directory); every input kind; a generative input's
  batch i the same whatever came before it; features independent of N (the
  last batch padded); the PRC swap; the weights-free contract of the JAX
  package's ``tests/test_weights_free_metrics.py`` at N <= 64.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import lpips as jlpips
from fastfourierconvolution_tpu.eval import pipeline as JP
from fastfourierconvolution_tpu.eval import registry as jregistry
from fastfourierconvolution_tpu_torch.data.datasets import ShapesDataset, SyntheticDataset
from fastfourierconvolution_tpu_torch.eval import clip as tc
from fastfourierconvolution_tpu_torch.eval import dinov2 as td
from fastfourierconvolution_tpu_torch.eval import metrics as M
from fastfourierconvolution_tpu_torch.eval import pipeline as P
from fastfourierconvolution_tpu_torch.eval import registry
from test_torch_inception import seeded_fidelity_state_dict
from test_torch_lpips import seeded_lpips_heads, seeded_vgg16_state_dict
from test_torch_ppl import stand_in

PARITY_RTOL = 1e-3
CPU = dict(device="cpu")


def shapes(seed, n=16, size=32):
    return ShapesDataset(n=n, size=size, seed=seed).images


def noise(seed, n=16, size=32):
    return SyntheticDataset(n=n, size=size, seed=seed).images


@pytest.fixture(scope="module", autouse=True)
def weights_free_env(tmp_path_factory):
    """No InceptionV3 file in reach, the default cache directory under a
    temporary FFC_TPU_HOME, torch on two intra-op threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("FFC_TPU_INCEPTION_WEIGHTS", raising=False)
        mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
        mp.setenv("FFC_TPU_HOME", str(tmp_path_factory.mktemp("ffc_home")))
        yield
    torch.set_num_threads(threads)


def test_calculate_metrics_matches_jax(tmp_path_factory):
    """ISC (deep logits), FID and KID from the same weights file on the same
    8 + 8 images, one batch each."""
    path = str(tmp_path_factory.mktemp("weights") / "inception.pth")
    torch.save(seeded_fidelity_state_dict(), path)
    a, b = shapes(0, n=8), noise(1, n=8)
    kw = dict(isc=True, fid=True, kid=True, isc_splits=2, kid_subsets=10, kid_subset_size=4,
              batch_size=8, feature_layer_fid="768", feature_extractor_weights_path=path,
              cache=False)
    ref = JP.calculate_metrics(a, b, **kw)
    ours = P.calculate_metrics(a, b, **kw, **CPU)
    assert sorted(ours) == sorted(ref) and len(ref) == 5
    for key, value in ref.items():
        assert abs(ours[key] - value) <= PARITY_RTOL * abs(value), (key, ours[key], value)


def test_fid_only_uses_cached_statistics(tmp_path, monkeypatch):
    """FID alone between two registered sets: features and statistics are
    written under the cache directory (atomically: no temporary file left),
    the weights-free tag in their names; a second call reads the statistics
    and builds no extractor. Another set under the same name is not read
    where ``cache=False``."""
    cache = str(tmp_path / "cache")
    P.register_dataset("pipeline-a", lambda: shapes(2))
    P.register_dataset("pipeline-b", lambda: noise(3))
    kw = dict(fid=True, batch_size=16, **CPU)
    first = P.calculate_metrics("pipeline-a", "pipeline-b", cache_dir=cache, **kw)
    names = sorted(os.listdir(cache))
    assert names == sorted(f"pipeline-{s}-inception-v3-compat-weights-free-{kind}-192.npz"
                           for s in "ab" for kind in ("features", "stat-fid"))
    stats = np.load(os.path.join(cache, names[1]))
    feats = np.load(os.path.join(cache, names[0]))["features"]
    assert feats.shape == (16, 192) and feats.dtype == np.float32
    assert np.array_equal(stats["mu"], M.fid_features_to_statistics(feats)["mu"])

    def no_extractor(*args, **kwargs):
        raise AssertionError("the cached statistics were not used")

    monkeypatch.setattr(P, "get_feature_extractor", no_extractor)
    again = P.calculate_metrics("pipeline-a", "pipeline-b", cache_dir=cache, **kw)
    assert again == first
    monkeypatch.undo()
    P.register_dataset("pipeline-b", lambda: shapes(4))
    fresh = P.calculate_metrics("pipeline-a", "pipeline-b", cache=False, **kw)
    assert fresh[M.KEY_FID] < first[M.KEY_FID]
    assert P.default_cache_dir() == os.path.join(os.environ["FFC_TPU_HOME"],
                                                 "fidelity_cache_torch")


def _images_of(z, labels=None):
    """A generative model's deterministic 8x8 images from its latents (and
    labels)."""
    x = z[:, :192].reshape(-1, 8, 8, 3)
    if labels is not None:
        x = x + labels[:, None, None, None].to(x.dtype)
    return (torch.sigmoid(x) * 255).to(torch.uint8)


def test_input_kinds_resolve_to_the_same_images(tmp_path):
    """An array, a tensor, a registered dataset and a callable give their
    images in order; a GenerativeModel (with and without labels) and a
    TorchScript model give the images of the latents (and labels) drawn for
    their batch; a float NCHW model output goes through torch-fidelity's
    conversion and grayscale is repeated."""
    data = shapes(5, n=10, size=8)
    P.register_dataset("pipeline-kinds", lambda: data)
    for spec in (data, torch.from_numpy(data), "pipeline-kinds"):
        sampler, total = P._resolve_input(spec, 0, 2020, 4, "cpu")
        assert total == 10
        batches = [sampler(i) for i in (0, 4, 8)]
        assert [take for _, take in batches] == [4, 4, 2]
        assert all(len(rows) == 4 for rows, _ in batches)  # the last one padded
        assert not batches[-1][0][2:].any()
        assert np.array_equal(
            torch.cat([torch.as_tensor(rows)[:take] for rows, take in batches]).numpy(), data)
    sampler, total = P._resolve_input(lambda n: data[:n], 7, 2020, 4, "cpu")
    rows, take = sampler(0)
    assert total == 7 and take == 4 and np.array_equal(np.asarray(rows), data[:4])
    rows, take = sampler(4)  # cut at the total
    assert take == 3 and np.array_equal(np.asarray(rows[:3]), data[:3]) and not rows[3:].any()

    for classes in (0, 5):
        gm = P.GenerativeModel(apply=_images_of, z_size=200, num_classes=classes, device="cpu")
        sampler, total = P._resolve_input(gm, 12, 7, 4, "cpu")
        g = P._batch_generator(7, 4, "cpu")
        z = torch.randn((4, 200), generator=g)
        labels = torch.randint(0, classes, (4,), generator=g) if classes else None
        assert total == 12 and torch.equal(sampler(4)[0], _images_of(z, labels))
        assert sampler(4)[1] == 4

    class Scripted(torch.nn.Module):
        def forward(self, z):
            return torch.tanh(z[:, :64].reshape(-1, 1, 8, 8))

    path = str(tmp_path / "g.pt")
    torch.jit.save(torch.jit.script(Scripted()), path)
    gm = P.torchscript_generative_model(path, z_size=64, **CPU)
    sampler, _ = P._resolve_input(gm, 4, 3, 4, "cpu")
    z = torch.randn((4, 64), generator=P._batch_generator(3, 0, "cpu"))
    want = (255.0 * (torch.tanh(z).reshape(-1, 8, 8, 1).clamp(-1, 1) * 0.5 + 0.5)).to(torch.uint8)
    assert torch.equal(sampler(0)[0], want.expand(-1, -1, -1, 3))
    with pytest.raises(RuntimeError, match="onnxruntime"):
        open(tmp_path / "g.onnx", "wb").close()
        P.onnx_generative_model(str(tmp_path / "g.onnx"), z_size=64)
    with pytest.raises(ValueError, match="uint8"):
        P._resolve_input(data.astype(np.float32), 0, 0, 4, "cpu")


def test_generative_batches_do_not_depend_on_the_order():
    """Batch i's latents come from (rng_seed, i) alone; another seed or
    another start gives others."""
    gm = P.GenerativeModel(apply=_images_of, z_size=200, num_classes=3)
    sampler, _ = P._resolve_input(gm, 16, 2020, 4, "cpu")
    late = sampler(8)[0]
    assert torch.equal(P._resolve_input(gm, 16, 2020, 4, "cpu")[0](8)[0], late)
    sampler(0), sampler(4)
    assert torch.equal(sampler(8)[0], late)
    assert not torch.equal(sampler(4)[0], late)
    assert not torch.equal(P._resolve_input(gm, 16, 2021, 4, "cpu")[0](8)[0], late)


def test_features_do_not_depend_on_n():
    """Batches of 4 over 6 images (the last one padded) give each image the
    features it gets alone in a batch of 4."""
    data = shapes(6, n=6)
    extractor = P.get_feature_extractor("inception-v3-compat", ("192",), batch_size=4, **CPU)
    all6 = extractor.extract(*P._resolve_input(data, 0, 0, 4, "cpu"))["192"]
    last2 = extractor.extract(*P._resolve_input(data[4:], 0, 0, 4, "cpu"))["192"]
    assert all6.shape == (6, 192) and np.array_equal(all6[4:], last2)


def test_prc_swaps_the_sets_for_a_generative_input1():
    """PRC on InceptionV3 features: a GenerativeModel in input1 and data in
    input2 read as (real = input2, generated = input1), unless told
    otherwise; features cached by name and reused."""
    gm = P.GenerativeModel(apply=lambda z: _images_of(z), z_size=200)
    real = shapes(7)
    kw = dict(prc=True, feature_extractor="inception-v3-compat", input1_model_num_samples=16,
              input1_cache_name="pipeline-gm", input2_cache_name="pipeline-real", batch_size=8,
              **CPU)
    swapped = P.calculate_metrics(gm, real, **kw)
    straight = P.calculate_metrics(gm, real, prc_input1_generated=False, **kw)
    cache = P.default_cache_dir()
    feats = {name: np.load(os.path.join(
        cache, f"{name}-inception-v3-compat-weights-free-features-192.npz"))["features"]
        for name in ("pipeline-gm", "pipeline-real")}
    assert swapped == M.prc_features_to_metric(feats["pipeline-real"], feats["pipeline-gm"])
    assert straight == M.prc_features_to_metric(feats["pipeline-gm"], feats["pipeline-real"])


@pytest.fixture(scope="module")
def weights_files(tmp_path_factory):
    """Seeded weights files in the upstream schemas: InceptionV3
    (torch-fidelity), vgg16 (torchvision), the LPIPS heads (toshas), a tiny
    CLIP ViT (OpenAI: width 64, 2 layers, 64px) and a 1-block
    ``dinov2-vit-s-14`` (facebookresearch)."""
    root = tmp_path_factory.mktemp("weights")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tc.VIT_META, "tiny", (16, 64, 2, 32, 64))
        clip_sd = tc.random_clip_state_dict("tiny", np.random.RandomState(0))
    dino_sd = td.random_dinov2_state_dict("dinov2-vit-s-14", np.random.RandomState(1),
                                          depth_override=1)
    states = {"inception": seeded_fidelity_state_dict(), "vgg16": seeded_vgg16_state_dict(),
              "lpips": seeded_lpips_heads(),
              "clip": {k: torch.from_numpy(v) for k, v in clip_sd.items()},
              "dinov2": {k: torch.from_numpy(v) for k, v in dino_sd.items()}}
    paths = {name: str(root / f"{name}.pth") for name in states}
    for name, state in states.items():
        torch.save(state, paths[name])
    return paths


@pytest.mark.parametrize("kwargs", [
    dict(prc=True), dict(isc=True, prc=True), dict(ppl=True),
    dict(fid=True, feature_extractor="vgg16"), dict(isc=True, feature_extractor="clip-vit-b-32"),
    dict(kid=True, feature_extractor="dinov2-vit-s-14"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_vgg16_lpips_clip_and_dinov2_requests_match_jax(kwargs, weights_files, monkeypatch):
    """PRC under the default extractors (VGG16; beside ISC the dual split,
    InceptionV3 for ISC), PPL (LPIPS over VGG16, on ``test_torch_ppl``'s
    stand-in model, the JAX similarity through its converter), and VGG16,
    CLIP and DINOv2 named as the extractor, on the same seeded weights files
    and 5 + 5 images as the JAX pipeline: every key within 1e-3 relative."""
    w = weights_files
    fe = kwargs.get("feature_extractor", "")
    if kwargs.get("fid"):
        # FID's eigenproblem on 4096-wide VGG16 features takes 17-40 s a call
        # on an 8-core CPU; both packages take the distance's other terms
        # instead (mean gap and the two traces: the statistics in full), and
        # the whole formula is held to JAX's in test_torch_eval_metrics
        def trace_terms(s1, s2):
            d = s1["mu"] - s2["mu"]
            return float(d.dot(d) + np.trace(s1["sigma"]) + np.trace(s2["sigma"]))

        monkeypatch.setattr(JP.M, "fid_statistics_to_metric", trace_terms)
        monkeypatch.setattr(P.M, "fid_statistics_to_metric", trace_terms)
    kw = dict(batch_size=5, cache=False, isc_splits=2, kid_subsets=4, kid_subset_size=4,
              vgg_weights_path=w["vgg16"], lpips_weights_path=w["lpips"],
              feature_extractor_weights_path=w["clip"] if fe.startswith("clip") else
              w["dinov2"] if fe.startswith("dinov2") else w["inception"], **kwargs)
    if kwargs.get("ppl"):
        monkeypatch.setitem(jregistry.SAMPLE_SIMILARITIES, "lpips-vgg16",
                            lambda resize, lpips_weights, vgg_weights: (
                                jlpips.LPIPS(resize=resize),
                                jlpips.load_lpips_torch_weights(lpips_weights, vgg_weights)))
        kw.update(input1_model_num_samples=12, ppl_sample_similarity_resize=None)
        ref = JP.calculate_metrics(JP.GenerativeModel(apply=stand_in, z_size=16), **kw)
        ours = P.calculate_metrics(P.GenerativeModel(apply=stand_in, z_size=16), **kw, **CPU)
    else:
        a, b = shapes(20, n=5), noise(21, n=5)
        ref = JP.calculate_metrics(a, b, **kw)
        ours = P.calculate_metrics(a, b, **kw, **CPU)
    assert sorted(ours) == sorted(ref) and ref
    for key, value in ref.items():
        assert np.isfinite(ours[key]), key
        assert abs(ours[key] - value) <= PARITY_RTOL * max(abs(value), 1e-12), (key, ours[key],
                                                                               value)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="internal_dtype"):
        P.calculate_metrics(shapes(8, n=8), isc=True, feature_extractor_internal_dtype="float16",
                            **CPU)
    with pytest.raises(ValueError, match="at least one metric"):
        P.calculate_metrics(shapes(8, n=8), **CPU)
    with pytest.raises(ValueError, match="need input2"):
        P.calculate_metrics(shapes(8, n=8), fid=True, **CPU)
    with pytest.raises(ValueError, match="registered already"):
        registry.register_noise_source("normal", lambda g, shape: None)
    with pytest.raises(ValueError, match="registered already"):
        registry.register_feature_extractor("inception-v3-compat", lambda *a, **k: None)


# --- the weights-free contract (the JAX package's tests/test_weights_free_metrics.py) ------

N_FREE = 32


def test_weights_free_default_layers_are_shallow():
    assert P._default_layer("inception-v3-compat", "fid") == "192"
    assert P._default_layer("inception-v3-compat", "kid") == "192"
    assert P._default_layer("inception-v3-compat", "isc") == "logits_unbiased"


def test_weights_free_fid_separates_unrelated_sets():
    a, b = shapes(10, n=N_FREE), shapes(11, n=N_FREE)
    unrelated = noise(12, n=N_FREE)
    kw = dict(fid=True, input1_cache_name="pipeline-free-a", batch_size=16, **CPU)
    same = P.calculate_metrics(a, b, **kw)[M.KEY_FID]
    differ = P.calculate_metrics(a, unrelated, **kw)[M.KEY_FID]
    assert differ > 10 * max(same, 1e-12), (same, differ)


def test_weights_free_isc_is_not_pinned_at_one():
    out = P.calculate_metrics(shapes(13, n=N_FREE), isc=True, isc_splits=4, cache=False,
                              batch_size=16, **CPU)
    assert abs(out[M.KEY_ISC_MEAN] - 1.0) > 1e-3, out
