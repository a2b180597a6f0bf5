"""The metric pipeline, the JAX package's ``eval/pipeline.py``:
``calculate_metrics``, torch-fidelity's ``calculate_metrics`` surface.

  * Two inputs (generated and reference), each a uint8 (N, H, W, 3) array
    or tensor, a callable sampler ``f(n) -> uint8 images``, a
    :class:`GenerativeModel`, a TorchScript or ONNX model file wrapped by
    :func:`torchscript_generative_model` or :func:`onnx_generative_model`,
    or the name of a registered dataset.
  * Features are extracted once per input on the device, in fixed-size
    batches (the last one padded, the padding dropped), under
    ``torch.inference_mode`` with TF32 off, and come back to the host as
    float32 numpy; ISC, FID, KID and PRC are computed from them in float64
    numpy (``eval/metrics.py``).
  * A generative input's latents (and labels) for the batch starting at
    index i come from a ``torch.Generator`` seeded by ``rng_seed`` and i,
    so batch i is the same whatever came before it. They are not
    ``jax.random``'s draws.
  * Features and FID statistics of a named input are cached on disk as
    ``{name}-{extractor}-features-{layer}.npz`` and
    ``{name}-{extractor}-stat-fid-{layer}.npz``, written atomically
    (tempfile and rename). The default directory is
    ``$FFC_TPU_HOME/fidelity_cache_torch`` (``~/.cache/ffc_tpu`` without
    ``FFC_TPU_HOME``), not the JAX package's ``fidelity_cache``: the two
    packages' weights-free extractors are different random nets, so
    features cached by one would silently give the other a wrong FID. A
    weights-free extractor's files carry ``-weights-free`` in the
    extractor part of the name for the same reason.
  * With the default extractors, PRC beside ISC, FID or KID is the
    dual-extractor split: one call without PRC (InceptionV3) and one with
    PRC alone (VGG16, torch-fidelity's default for it). VGG16 reads
    ``vgg_weights_path``, every other extractor
    ``feature_extractor_weights_path``.
  * ``ppl=True`` runs ``eval.ppl.calculate_ppl`` on a
    :class:`GenerativeModel` ``input1``, whose latents come from
    ``np.random.RandomState(rng_seed)`` as in the JAX package.
  * In a process group (``parallel``; the JAX package's ``mesh=``) every
    process resolves the same inputs; of each batch it generates (a
    generative input) or takes (an array, a dataset, a sampler, whose
    content must be the same everywhere) its rows and extracts their
    features, which are gathered in rank order, so every process holds the
    whole feature set and computes the same metrics. A cache hit counts
    only where every process has the files (``parallel.mp_and``). PPL runs
    whole in every process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import parallel
from ..utils.policy import resolve_device
from . import metrics as M
from . import registry
from .inception import DEFAULT_FEATURE_LAYER_WEIGHTS_FREE, internal_dtype_of, weights_available
from .registry import register_dataset, registered_datasets  # noqa: F401  (the JAX names)

CACHE_SUBDIR = "fidelity_cache_torch"
# torch-fidelity's per-metric default extractors (utils.py): PRC's is VGG16.
DEFAULT_FEATURE_EXTRACTOR = {"isc": "inception-v3-compat", "fid": "inception-v3-compat",
                             "kid": "inception-v3-compat", "prc": "vgg16"}


def default_cache_dir() -> str:
    """``$FFC_TPU_HOME/fidelity_cache_torch``, read when called."""
    home = os.path.expanduser(os.environ.get("FFC_TPU_HOME", "~/.cache/ffc_tpu"))
    return os.path.join(home, CACHE_SUBDIR)


@dataclasses.dataclass
class GenerativeModel:
    """A sampler with its latent spec (torch-fidelity's
    GenerativeModelModuleWrapper): ``apply(z)`` or, with ``num_classes``,
    ``apply(z, labels)`` -> images (B, H, W, 3) uint8, or anything
    :func:`_normalize_model_images` takes. ``z_type`` names a noise source
    of ``registry.NOISE_SOURCES``. Latents and labels are drawn on
    ``device`` (None: the pipeline's device)."""

    apply: Callable
    z_size: int
    z_type: str = "normal"
    num_classes: int = 0
    device: Optional[object] = None


def _normalize_model_images(images) -> torch.Tensor:
    """A generative model's output batch as the uint8 NHWC contract of every
    input kind: NCHW transposed where it is evident, float outputs through
    torch-fidelity's eval conversion ``255 * (clamp(-1, 1) * 0.5 + 0.5)``
    (truncated), grayscale repeated to RGB."""
    x = torch.as_tensor(images)
    if x.dim() != 4:
        raise ValueError(f"a model must give NCHW or NHWC images, got {tuple(x.shape)}")
    if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.permute(0, 2, 3, 1)
    if x.dtype != torch.uint8:
        x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
        x = (255.0 * (x.clamp(-1.0, 1.0) * 0.5 + 0.5)).to(torch.uint8)
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return x


def torchscript_generative_model(path: str, z_size: int, z_type: str = "normal",
                                 num_classes: int = 0, device="cuda") -> GenerativeModel:
    """A TorchScript generative model file (torch-fidelity's JIT-model input
    kind), loaded on ``device``: the module maps latents (and int64 labels
    where ``num_classes`` > 0) to images."""
    device = resolve_device(device)
    module = torch.jit.load(path, map_location=device).eval()

    def apply(z, labels=None):
        with torch.no_grad():
            out = module(z) if labels is None else module(z, labels)
        return _normalize_model_images(out)

    return GenerativeModel(apply=apply, z_size=z_size, z_type=z_type,
                           num_classes=num_classes, device=device)


def onnx_generative_model(path: str, z_size: int, z_type: str = "normal",
                          num_classes: int = 0) -> GenerativeModel:
    """An ``.onnx`` generative model (torch-fidelity's GenerativeModelONNX),
    run through onnxruntime on the host; it maps latents (and int64 labels
    where ``num_classes`` > 0) to images. onnxruntime is optional, as in
    torch-fidelity: without it this raises with the alternatives."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f'ONNX model file not found at "{path}"')
    if z_size <= 0:
        raise ValueError("z_size must be a positive integer")
    if z_type not in registry.NOISE_SOURCES:
        raise ValueError(f"unknown z_type {z_type!r}; known: {sorted(registry.NOISE_SOURCES)}")
    try:
        import onnxruntime
    except ImportError as e:
        raise RuntimeError(
            "Loading ONNX generative models requires the 'onnxruntime' package, which is "
            "not installed (torch-fidelity treats it as optional too). Pass a GenerativeModel "
            "or a TorchScript .pt/.pth model to calculate_metrics instead.") from e
    session = onnxruntime.InferenceSession(path)
    input_names = [a.name for a in session.get_inputs()]

    def apply(z, labels=None):
        feeds = [np.asarray(torch.as_tensor(z).cpu(), np.float32)]
        if labels is not None:
            feeds.append(np.asarray(torch.as_tensor(labels).cpu(), np.int64))
        if len(feeds) != len(input_names):
            raise ValueError(f"ONNX model declares inputs {input_names}, got {len(feeds)} "
                             f"arguments")
        out = session.run(None, dict(zip(input_names, feeds)))[0]
        if not isinstance(out, np.ndarray):
            raise TypeError(f"invalid ONNX model output: {type(out)}")
        return _normalize_model_images(out)

    return GenerativeModel(apply=apply, z_size=z_size, z_type=z_type, num_classes=num_classes,
                           device="cpu")


def _batch_generator(rng_seed: int, start: int, device) -> torch.Generator:
    """The generator of the batch starting at sample ``start``: seeded by
    (rng_seed, start) alone."""
    seed = np.random.SeedSequence([rng_seed, start]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(seed))


def _uint8_images(data, what: str):
    if tuple(data.shape[3:]) != (3,) or data.dim() != 4 or data.dtype != torch.uint8:
        raise ValueError(f"{what} must be uint8 (N, H, W, 3), got {data.dtype} "
                         f"{tuple(data.shape)}")
    return data


def _rows_of(sampler, total: int, batch_size: int):
    """A sampler of (this process's rows of the batch at ``start``, cut at
    ``total`` and padded with zeros to ``batch_size``, the batch's length
    before the padding): the whole padded batch without a process group."""
    def rows(i):
        batch = torch.as_tensor(sampler(i))
        take = min(len(batch), total - i)
        batch = batch[:take]
        if 0 < take < batch_size:
            batch = torch.cat([batch, batch.new_zeros((batch_size - take,) + batch.shape[1:])])
        return parallel.shard_full_batch(batch), take

    return rows


def _resolve_input(spec, num_samples: int, rng_seed: int, batch_size: int, device):
    """``(sampler, total)``: ``sampler(start)`` gives (this process's rows
    of the batch of uint8 images starting at sample ``start``, the batch's
    length), for any input kind: the batch cut at ``total`` and padded with
    zeros to ``batch_size``, and without a process group the whole of it
    (``parallel.shard_full_batch``); a generative input generates only this
    process's rows of its ``batch_size`` latents."""
    if isinstance(spec, str):
        if spec not in registry._DATASETS:
            raise KeyError(f"dataset '{spec}' not registered; known: {registered_datasets()}")
        spec = np.asarray(registry._DATASETS[spec]())
    if isinstance(spec, (np.ndarray, torch.Tensor)):
        data = _uint8_images(torch.as_tensor(spec), "image inputs")
        n = min(num_samples, len(data)) if num_samples else len(data)
        return _rows_of(lambda i: data[i:i + batch_size], n, batch_size), n
    if isinstance(spec, GenerativeModel):
        if not num_samples:
            raise ValueError("a generative input needs input*_model_num_samples")
        if spec.z_type not in registry.NOISE_SOURCES:
            raise ValueError(f"unknown z_type {spec.z_type!r}; known: "
                             f"{sorted(registry.NOISE_SOURCES)}")
        at = resolve_device(spec.device if spec.device is not None else device)
        rows = parallel.shard_full_batch

        def from_model(i):
            g = _batch_generator(rng_seed, i, at)
            z = registry.NOISE_SOURCES[spec.z_type](g, (batch_size, spec.z_size))
            if spec.num_classes > 0:
                labels = torch.randint(0, spec.num_classes, (batch_size,), generator=g,
                                       device=at)
                images = spec.apply(rows(z), rows(labels))
            else:
                images = spec.apply(rows(z))
            return _normalize_model_images(images), min(batch_size, num_samples - i)

        return from_model, num_samples
    if callable(spec):
        return _rows_of(lambda i: spec(batch_size), num_samples, batch_size), num_samples
    raise TypeError(f"cannot resolve metric input: {type(spec)}")


@contextlib.contextmanager
def _full_f32():
    """TF32 off for products and convolutions, restored afterwards."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


class FeatureExtractor:
    """Batched feature extraction on ``device`` with a registered extractor."""

    def __init__(self, features_list: Sequence[str], weights_path: Optional[str] = None,
                 batch_size: int = 128, name: str = "inception-v3-compat",
                 internal_dtype: Optional[str] = None, device="cuda"):
        internal_dtype_of(internal_dtype)
        if name not in registry.FEATURE_EXTRACTORS:
            raise KeyError(f"feature extractor '{name}' not registered; known: "
                           f"{sorted(registry.FEATURE_EXTRACTORS)}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.name = name
        self.features_list = tuple(sorted(set(features_list)))
        self.batch_size = batch_size
        self.device = resolve_device(device)
        factory = registry.FEATURE_EXTRACTORS[name]["factory"]
        self.module = factory(self.features_list, weights_path, internal_dtype=internal_dtype,
                              device=self.device)

    def extract(self, sampler, total: int) -> Dict[str, np.ndarray]:
        """{tap: float32 (total, D)} over the batches ``sampler`` gives
        (``_resolve_input``). Every batch is ``batch_size`` images (the last
        one padded with zeros, the padding dropped), so the card runs one
        set of convolution plans and an image's features do not depend on
        N. In a process group each process extracts its rows of each batch
        and the features are gathered in rank order, so every process holds
        them all."""
        chunks: Dict[str, list] = {f: [] for f in self.features_list}
        i = 0
        while i < total:
            # a generative sampler runs as its model runs, outside the
            # extractor's inference mode and TF32 setting
            rows, take = sampler(i)
            if take <= 0:
                break
            x = _uint8_images(torch.as_tensor(rows), "a batch").to(self.device)
            with torch.inference_mode(), _full_f32():
                feats = self.module(x)
            for k in self.features_list:
                whole = parallel.all_gather_rows(feats[k].float().clone())
                chunks[k].append(whole[:take].cpu().numpy())
            i += take
        return {k: np.concatenate(v, axis=0) for k, v in chunks.items()}


# One extractor per key for the process: building one (and the card's first
# convolution plans) is the expensive part of an eval epoch.
_EXTRACTOR_CACHE: Dict[tuple, FeatureExtractor] = {}


def get_feature_extractor(name: str, features_list: Sequence[str],
                          weights_path: Optional[str] = None, batch_size: int = 128,
                          internal_dtype: Optional[str] = None,
                          device="cuda") -> FeatureExtractor:
    device = resolve_device(device)
    key = (name, tuple(sorted(set(features_list))), weights_path, batch_size, internal_dtype,
           str(device))
    if key not in _EXTRACTOR_CACHE:
        _EXTRACTOR_CACHE[key] = FeatureExtractor(features_list, weights_path, batch_size, name,
                                                 internal_dtype=internal_dtype, device=device)
    return _EXTRACTOR_CACHE[key]


def _default_layer(extractor_name: str, metric: str, weights_path: Optional[str] = None) -> str:
    """The tap ``metric`` reads by default: for the InceptionV3 without
    weights the shallow ones, whose features still tell images apart."""
    if extractor_name == "inception-v3-compat" and not weights_available(weights_path):
        return DEFAULT_FEATURE_LAYER_WEIGHTS_FREE[metric]
    spec = registry.FEATURE_EXTRACTORS.get(extractor_name, {})
    if "default_layers" in spec:
        return spec["default_layers"][metric]
    raise KeyError(f"extractor '{extractor_name}' declares no default_layers; pass "
                   f"feature_layer_{metric}=... or register it with default_layers")


def _resolve_extractor_name(feature_extractor, isc, fid, kid, prc) -> str:
    """torch-fidelity's resolve_feature_extractor: an explicit name wins;
    otherwise the defaults of the requested metrics must agree."""
    if feature_extractor is not None:
        return feature_extractor
    names = {DEFAULT_FEATURE_EXTRACTOR[m] for m, on in
             (("isc", isc), ("fid", fid), ("kid", kid), ("prc", prc)) if on}
    if len(names) != 1:
        raise ValueError(f"cannot have several feature extractors in one call: {sorted(names)}")
    return names.pop()


def _cache_path(cache_dir: str, input_name: str, extractor_tag: str, layer: str) -> str:
    return os.path.join(cache_dir, f"{input_name}-{extractor_tag}-features-{layer}.npz")


def _atomic_save(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` to ``path`` through a temporary file in its directory and
    a rename, so a reader never sees a partial file."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def calculate_metrics(
    input1,
    input2=None,
    *,
    isc: bool = False,
    fid: bool = False,
    kid: bool = False,
    prc: bool = False,
    ppl: bool = False,
    feature_extractor: Optional[str] = None,
    feature_layer_isc: Optional[str] = None,
    feature_layer_fid: Optional[str] = None,
    feature_layer_kid: Optional[str] = None,
    feature_layer_prc: Optional[str] = None,
    input1_model_num_samples: int = 10000,
    input2_model_num_samples: int = 10000,
    input1_cache_name: Optional[str] = None,
    input2_cache_name: Optional[str] = None,
    batch_size: int = 128,
    rng_seed: int = 2020,
    isc_splits: int = 10,
    kid_subsets: int = 100,
    kid_subset_size: int = 1000,
    kid_kernel: str = "poly",
    kid_kernel_poly_degree: int = 3,
    kid_kernel_poly_gamma: Optional[float] = None,
    kid_kernel_poly_coef0: float = 1.0,
    kid_kernel_rbf_sigma: float = 10.0,
    prc_neighborhood: int = 3,
    prc_batch_size: int = 10000,
    prc_input1_generated: Optional[bool] = None,
    save_cpu_ram: bool = False,
    ppl_epsilon: float = 1e-4,
    ppl_sample_similarity: str = "lpips-vgg16",
    ppl_z_interp_mode: str = "lerp",
    ppl_reduction: str = "mean",
    ppl_sample_similarity_resize: Optional[int] = 64,
    ppl_discard_percentile_lower: Optional[float] = 1.0,
    ppl_discard_percentile_higher: Optional[float] = 99.0,
    feature_extractor_weights_path: Optional[str] = None,
    feature_extractor_internal_dtype: Optional[str] = None,
    lpips_weights_path: Optional[str] = None,
    vgg_weights_path: Optional[str] = None,
    cache: bool = True,
    cache_dir: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """The requested metrics, with torch-fidelity's keywords and defaults:
    per-metric default extractors and taps with the dual-extractor split
    (see the module docstring), ``feature_extractor`` and
    ``feature_layer_*`` overrides, KID's poly and rbf kernels, FID from
    cached statistics alone where only FID is asked, the on-disk cache
    (``cache_dir`` None: :func:`default_cache_dir`) and PPL
    (``eval.ppl.calculate_ppl`` with the ``ppl_*``, ``lpips_weights_path``
    and ``vgg_weights_path`` keywords). Features and distances are computed
    on ``device``.

    PRC reads ``features_1`` as the real set (torch-fidelity's convention);
    ``prc_input1_generated`` swaps the two feature sets at the PRC call,
    and None swaps exactly where ``input1`` is a :class:`GenerativeModel`
    and ``input2`` is not (the in-training layout). In a process group
    the feature extraction is split over the processes (module
    docstring)."""
    keywords = dict(locals())
    if not (isc or fid or kid or prc or ppl):
        raise ValueError("at least one metric must be requested")
    internal_dtype_of(feature_extractor_internal_dtype)
    if (fid or kid or prc) and input2 is None:
        raise ValueError("fid, kid and prc need input2")
    if ppl and not isinstance(input1, GenerativeModel):
        raise ValueError("ppl needs a GenerativeModel input1")
    if feature_extractor is None and prc and (isc or fid or kid):
        # torch-fidelity's split: InceptionV3 for ISC/FID/KID (and PPL), VGG16
        # for PRC
        for name in ("isc", "fid", "kid", "prc", "ppl"):
            keywords.pop(name)
        out = calculate_metrics(isc=isc, fid=fid, kid=kid, ppl=ppl, **keywords)
        out.update(calculate_metrics(prc=True, **keywords))
        return out
    if cache_dir is None:
        keywords["cache_dir"] = default_cache_dir()
    out: Dict[str, float] = {}
    if isc or fid or kid or prc:
        out.update(_feature_metrics(**keywords))
    if ppl:
        from .ppl import calculate_ppl

        out.update(calculate_ppl(
            input1, num_samples=input1_model_num_samples, epsilon=ppl_epsilon,
            interp=ppl_z_interp_mode, batch_size=batch_size,
            similarity_resize=ppl_sample_similarity_resize,
            discard_percentile_lower=ppl_discard_percentile_lower,
            discard_percentile_higher=ppl_discard_percentile_higher, rng_seed=rng_seed,
            lpips_weights=lpips_weights_path, vgg_weights=vgg_weights_path,
            reduction=ppl_reduction, similarity_name=ppl_sample_similarity, device=device))
    if verbose:
        for k, v in out.items():
            if np.ndim(v) == 0:
                print(f"{k}: {v:.7g}")
    return out


def _feature_metrics(input1, input2, *, isc, fid, kid, prc, feature_extractor,
                     feature_layer_isc, feature_layer_fid, feature_layer_kid, feature_layer_prc,
                     input1_model_num_samples, input2_model_num_samples, input1_cache_name,
                     input2_cache_name, batch_size, rng_seed, isc_splits, kid_subsets,
                     kid_subset_size, kid_kernel, kid_kernel_poly_degree, kid_kernel_poly_gamma,
                     kid_kernel_poly_coef0, kid_kernel_rbf_sigma, prc_neighborhood,
                     prc_batch_size, prc_input1_generated, save_cpu_ram,
                     feature_extractor_weights_path, feature_extractor_internal_dtype,
                     vgg_weights_path, cache, cache_dir, device, **_) -> Dict[str, float]:
    """ISC, FID, KID and PRC of ``calculate_metrics`` on one extractor."""
    out: Dict[str, float] = {}
    fe_name = _resolve_extractor_name(feature_extractor, isc, fid, kid, prc)
    if fe_name not in registry.FEATURE_EXTRACTORS:
        raise KeyError(f"feature extractor '{fe_name}' not registered; known: "
                       f"{sorted(registry.FEATURE_EXTRACTORS)}")
    weights = vgg_weights_path if fe_name == "vgg16" else feature_extractor_weights_path
    tag = fe_name
    if not registry.FEATURE_EXTRACTORS[fe_name]["has_weights"](weights):
        tag += "-weights-free"
    layer_of = {
        "isc": feature_layer_isc or _default_layer(fe_name, "isc", weights),
        "fid": feature_layer_fid or _default_layer(fe_name, "fid", weights),
        "kid": feature_layer_kid or _default_layer(fe_name, "kid", weights),
        "prc": feature_layer_prc or _default_layer(fe_name, "prc", weights),
    }
    wanted_layers = tuple(sorted({layer_of[m] for m, on in
                                  (("isc", isc), ("fid", fid), ("kid", kid), ("prc", prc))
                                  if on}))

    def hit(found) -> bool:
        """A cache hit: the files found here and, in a process group, in
        every process."""
        return parallel.mp_and(bool(cache and found))

    def features_for(spec, num_samples, cache_name):
        paths = {l: _cache_path(cache_dir, cache_name, tag, l) for l in wanted_layers}
        if hit(cache_name and all(os.path.exists(p) for p in paths.values())):
            return {l: np.load(p)["features"] for l, p in paths.items()}
        sampler, total = _resolve_input(spec, num_samples, rng_seed, batch_size, device)
        # built only here: a call that finds everything cached needs no
        # extractor
        extractor = get_feature_extractor(fe_name, wanted_layers, weights, batch_size,
                                          feature_extractor_internal_dtype, device)
        feats = extractor.extract(sampler, total)
        if cache and cache_name:
            for l, arr in feats.items():
                _atomic_save(paths[l], {"features": arr})
        return feats

    def fid_stats_for(spec, num_samples, cache_name, feats=None):
        """mu and sigma, cached as statistics too (torch-fidelity's
        fid_featuresdict_to_statistics_cached); ``feats``: features in hand."""
        layer = layer_of["fid"]
        path = (os.path.join(cache_dir, f"{cache_name}-{tag}-stat-fid-{layer}.npz")
                if cache_name else None)
        if hit(path and os.path.exists(path)):
            data = np.load(path)
            return {"mu": data["mu"], "sigma": data["sigma"]}
        if feats is None:
            feats = features_for(spec, num_samples, cache_name)
        stat = M.fid_features_to_statistics(feats[layer])
        if cache and path:
            _atomic_save(path, stat)
        return stat

    name1 = input1_cache_name or (input1 if isinstance(input1, str) else None)
    name2 = input2_cache_name or (input2 if isinstance(input2, str) else None)
    feats1 = feats2 = None
    if fid and not (isc or kid or prc):
        # FID alone: cached statistics spare the features
        out[M.KEY_FID] = M.fid_statistics_to_metric(
            fid_stats_for(input1, input1_model_num_samples, name1),
            fid_stats_for(input2, input2_model_num_samples, name2))
    else:
        feats1 = features_for(input1, input1_model_num_samples, name1)
        if fid or kid or prc:
            feats2 = features_for(input2, input2_model_num_samples, name2)

    if isc:
        out.update(M.isc_features_to_metric(feats1[layer_of["isc"]], splits=isc_splits,
                                            rng_seed=rng_seed))
    if fid and feats1 is not None:
        # the statistics of named inputs are cached for the next FID-only call
        out[M.KEY_FID] = M.fid_statistics_to_metric(
            fid_stats_for(input1, input1_model_num_samples, name1, feats=feats1),
            fid_stats_for(input2, input2_model_num_samples, name2, feats=feats2))
    if kid:
        out.update(M.kid_features_to_metric(
            feats1[layer_of["kid"]], feats2[layer_of["kid"]], subsets=kid_subsets,
            subset_size=kid_subset_size, degree=kid_kernel_poly_degree,
            gamma=kid_kernel_poly_gamma, coef0=kid_kernel_poly_coef0, kernel=kid_kernel,
            rbf_sigma=kid_kernel_rbf_sigma, rng_seed=rng_seed))
    if prc:
        swap = prc_input1_generated
        if swap is None:
            # only a GenerativeModel marks an input as generated: a plain
            # callable may as well feed real images
            swap = (isinstance(input1, GenerativeModel)
                    and not isinstance(input2, GenerativeModel))
        f_real, f_gen = (feats2, feats1) if swap else (feats1, feats2)
        out.update(M.prc_features_to_metric(
            f_real[layer_of["prc"]], f_gen[layer_of["prc"]], neighborhood=prc_neighborhood,
            batch_size=prc_batch_size, save_cpu_ram=save_cpu_ram))
    return out
