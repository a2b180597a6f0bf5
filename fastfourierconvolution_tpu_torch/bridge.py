"""Turn the JAX package's variables into the port's state dict.

Input: the JAX model's ``params``, ``batch_stats`` and ``spectral``
collections as nested dicts of numpy arrays (``jax.device_get`` of the
flax variables). Output: a state dict for the port's module, in torch
layouts:

- convolution HWIO -> OIHW (spectral-normed ones too);
- transposed convolution: the JAX kernel is HWIO and spatially flipped,
  torch's is IOHW, so ``w_t[i, o, a, b] = w_j[k-1-a, k-1-b, i, o]``;
- grouped convolutions: the JAX kernel is HWIO with I = cin / groups, so
  OIHW needs no more than the plain transpose; a grouped transposed one
  (JAX I = cin / groups, O = cout; torch IOHW with O = cout / groups)
  takes group g's output columns to the rows of g's input channels:
  ``w_t[g*ci + i, o, a, b] = w_j[k-1-a, k-1-b, i, g*co + o]``;
- Dense (in, out) -> (out, in), SN dense too: the port's discriminator
  flattens its features in the JAX package's (H, W, C) order, so the
  head's columns need no permutation;
- FourierUnit ``mix_kernel`` (2C, 2C) as it is: both packages order the
  spectral channels [re; im];
- BatchNorm scale/bias/mean/var, biases and spectral-norm ``u`` as they
  are (``u`` runs over output features in both packages, and over input
  channels for a spectral-normed transposed convolution in both);
- a spectral-normed transposed convolution's kernel flipped as a
  transposed convolution's: the flip permutes the columns of the matrix
  spectral norm reads, so sigma and ``u`` carry over;
- ``SelfAttention``: its q, k and v convolutions (flax's ``Conv2d_0``,
  ``Conv2d_1``, ``Conv2d_2``) and the scalar ``gamma``;
- the FFC layer options: the local Fourier unit (``lfu``) of a
  SpectralTransform, spectral-normed FFC branches (kernel, bias and
  ``u``, transposed ones included), and the kernels and biases of packed
  FFCs, whose JAX ``ConvKernelHolder``s carry the conv branches' names
  and leaves.

The generator and both discriminators go through the same rules:
``FFCDiscriminator``'s biased FFC convolutions, its blocks' BatchNorms,
its FourierUnits' BN and its head's ``u`` included. So do the
class-conditional models (``models/conditional.py``): label tables
(``label_embed``) as they are, ConditionalBatchNorm's per-class gamma and
beta tables and statistics (also in a class-conditional FourierUnit),
transposed-convolution biases, bias-free spectral-normed convolutions; and
the comparator models (``models/dcgan.py``, ``models/sngan_resnet.py``,
``models/sagan.py``), whose port modules carry their flax twins' names.
``zoo.TupleHeadWrapper`` is seen through: the JAX package does not nest
the wrapped model's variables under it, so they load into
``wrapper.module``.

Every JAX leaf must be consumed exactly once and every port parameter and
buffer filled; anything else raises. ``jax_params_to_state_dict`` takes a
tree in the ``params`` collection's layout alone (the parameters, or an
optax Adam state's moments, which take the same converters) to the
model's parameters.

``inception_variables_to_state_dict`` maps the JAX package's InceptionV3
variables (``eval/inception.py``) to the port's ``eval.inception``
names, torch-fidelity's; ``vgg16_variables_to_state_dict`` and
``lpips_variables_to_state_dict`` map its VGG16 and LPIPS variables
(``eval/lpips.py``) to the port's ``eval.lpips`` names, torchvision's and
the toshas heads'.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .nn.ffc import FourierUnit, SpectralTransform
from .nn.layers import (
    BatchNorm,
    ConditionalBatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
    LabelEmbedding,
    NoiseInjection,
    SELayer,
    SelfAttention,
    SNConv2d,
    SNConvTranspose2d,
    SNDense,
)
from .zoo import TupleHeadWrapper

# Port child name -> the name flax gives the same submodule, for the port
# modules whose flax twins name their children automatically; None where
# the flax twin has no module of its own (the child's variables sit in the
# parent's scope).
_JAX_CHILD_NAMES = {
    SpectralTransform: {
        "se": "SELayer_0",
        "conv1": "Conv2d_0",
        "bn": "BatchNorm_0",
        "fu": "FourierUnit_0",
        "lfu": "lfu",
        "conv2": "Conv2d_1",
    },
    SELayer: {"fc1": "Dense_0", "fc2": "Dense_1"},
    FourierUnit: {"bn": "ConditionalBatchNorm_0"},
    SelfAttention: {"query": "Conv2d_0", "key": "Conv2d_1", "value": "Conv2d_2"},
    TupleHeadWrapper: {"module": None},
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _jax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{port module name: the flax module path of its twin}."""
    paths = {"": ()}

    def walk(module: nn.Module, name: str, path: Tuple[str, ...]) -> None:
        table = _JAX_CHILD_NAMES.get(type(module), {})
        for child_name, child in module.named_children():
            full = f"{name}.{child_name}" if name else child_name
            jax_name = table.get(child_name, child_name)
            paths[full] = path if jax_name is None else path + (jax_name,)
            walk(child, full, paths[full])

    walk(model, "", ())
    return paths


def _leaf_rules(module: nn.Module):
    """(port attribute, collection, JAX leaf path suffix, converter)."""
    conv = lambda w: w.transpose(3, 2, 0, 1)
    convt = lambda w: _grouped_convt(w, getattr(module, "groups", 1))
    dense = lambda w: w.T
    same = lambda w: w
    bias = [("bias", "params", ("bias",), same)] if getattr(module, "bias", None) is not None else []
    if isinstance(module, SNConvTranspose2d):
        return [("weight", "params", ("kernel",), convt), *bias, ("u", "spectral", ("u",), same)]
    if isinstance(module, (SNConv2d, SNDense)):
        return [
            ("weight", "params", ("kernel",), conv if isinstance(module, SNConv2d) else dense),
            *bias,
            ("u", "spectral", ("u",), same),
        ]
    if isinstance(module, Conv2d):
        return [("weight", "params", ("kernel",), conv), *bias]
    if isinstance(module, ConvTranspose2d):
        return [("weight", "params", ("kernel",), convt), *bias]
    if isinstance(module, Dense):
        return [("weight", "params", ("kernel",), dense), *bias]
    if isinstance(module, BatchNorm):
        return [
            ("weight", "params", ("BatchNorm_0", "scale"), same),
            ("bias", "params", ("BatchNorm_0", "bias"), same),
            ("running_mean", "batch_stats", ("BatchNorm_0", "mean"), same),
            ("running_var", "batch_stats", ("BatchNorm_0", "var"), same),
        ]
    if isinstance(module, ConditionalBatchNorm):
        return [
            ("gamma", "params", ("gamma",), same),
            ("beta", "params", ("beta",), same),
            ("running_mean", "batch_stats", ("BatchNorm_0", "mean"), same),
            ("running_var", "batch_stats", ("BatchNorm_0", "var"), same),
        ]
    if isinstance(module, LabelEmbedding):
        return [("weight", "params", (), same)]
    if isinstance(module, FourierUnit) and module.bn is not None:
        return [("mix_kernel", "params", ("mix_kernel",), same)]
    if isinstance(module, FourierUnit):
        return [
            ("mix_kernel", "params", ("mix_kernel",), same),
            ("bn_scale", "params", ("bn_scale",), same),
            ("bn_bias", "params", ("bn_bias",), same),
            ("running_mean", "batch_stats", ("mean",), same),
            ("running_var", "batch_stats", ("var",), same),
        ]
    if isinstance(module, SelfAttention):
        return [("gamma", "params", ("gamma",), same)]
    if isinstance(module, NoiseInjection):
        return [("weight", "params", ("weight",), lambda w: w.reshape(-1))]
    return []


def _grouped_convt(w: np.ndarray, groups: int) -> np.ndarray:
    """JAX HWIO (k, k, cin / groups, cout), spatially flipped -> torch IOHW
    (cin, cout / groups, k, k)."""
    k1, k2, ci, co = w.shape
    w = w[::-1, ::-1].reshape(k1, k2, ci, groups, co // groups)
    return w.transpose(3, 2, 4, 0, 1).reshape(groups * ci, co // groups, k1, k2)


def jax_to_state_dict(
    model: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None,
    spectral: Optional[Mapping] = None,
) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` from the JAX variables of the same model."""
    return _convert(model, {"params": params, "batch_stats": batch_stats or {},
                            "spectral": spectral or {}}, model.state_dict())


def jax_params_to_state_dict(model: nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """``model``'s parameters alone, in ``named_parameters()`` order, from a
    tree in the layout of the JAX ``params`` collection: the parameters
    themselves, or a tree of the same layout such as an optax Adam state's
    ``mu`` and ``nu``, which take the parameters' converters."""
    names = [name for name, _ in model.named_parameters()]
    state = _convert(model, {"params": params}, names)
    return {name: state[name] for name in names}


def _convert(model: nn.Module, trees: Mapping[str, Mapping], wanted) -> Dict[str, torch.Tensor]:
    """The port entries of ``model`` that the collections in ``trees`` fill;
    raises unless every leaf is taken once and every name of ``wanted``
    filled."""
    leaves = {collection: _flatten(tree) for collection, tree in trees.items()}
    consumed = {name: set() for name in leaves}
    state: Dict[str, torch.Tensor] = {}
    expected = model.state_dict()
    jax_paths = _jax_paths(model)
    for name, module in model.named_modules():
        for attr, collection, suffix, convert in _leaf_rules(module):
            if collection not in leaves:
                continue
            key = f"{name}.{attr}" if name else attr
            path = jax_paths[name] + suffix
            if path not in leaves[collection]:
                raise KeyError(f"{key}: no JAX leaf {collection}/{'/'.join(path)}")
            if path in consumed[collection]:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} used twice")
            consumed[collection].add(path)
            value = np.array(convert(leaves[collection][path]), order="C")
            if value.shape != tuple(expected[key].shape):
                raise ValueError(
                    f"{key}: JAX leaf {'/'.join(path)} gives shape {value.shape}, "
                    f"the port wants {tuple(expected[key].shape)}"
                )
            state[key] = torch.from_numpy(value.astype(np.float32))
    for collection, table in leaves.items():
        unused = sorted("/".join(p) for p in set(table) - consumed[collection])
        if unused:
            raise KeyError(f"JAX {collection} leaves the port does not take: {unused}")
    missing = sorted(set(wanted) - set(state))
    if missing:
        raise KeyError(f"port entries the JAX variables do not fill: {missing}")
    return state


# The JAX InceptionV3's per-convolution leaves -> the port's (torch-fidelity's) names.
_INCEPTION_LEAVES = {
    "kernel": "conv.weight",
    "bn_scale": "bn.weight",
    "bn_bias": "bn.bias",
    "bn_mean": "bn.running_mean",
    "bn_var": "bn.running_var",
}
_INCEPTION_HEAD = {"fc_kernel": "fc.weight", "fc_bias": "fc.bias",
                   "fc192_kernel": "fc192.weight", "fc192_bias": "fc192.bias"}


def inception_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``eval.inception.InceptionV3`` entries for the JAX
    package's InceptionV3 variables (``{"params": {...}}``, nested by module
    name): HWIO kernels to OIHW, the fc and fc192 kernels transposed, the
    frozen BN's scale, bias, mean and var to the BN's weight, bias,
    running_mean and running_var. Only the modules the variables hold: a
    JAX extractor initialised for shallow taps holds the stem alone."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]).items():
        *modules, leaf = path
        if not modules and leaf in _INCEPTION_HEAD:
            name = _INCEPTION_HEAD[leaf]
            value = value.T if leaf.endswith("kernel") else value
        elif modules and leaf in _INCEPTION_LEAVES:
            name = ".".join(modules) + "." + _INCEPTION_LEAVES[leaf]
            value = value.transpose(3, 2, 0, 1) if leaf == "kernel" else value
        else:
            raise KeyError(f"JAX InceptionV3 leaf params/{'/'.join(path)} has no port entry")
        state[name] = torch.from_numpy(np.array(value, order="C"))
    return state


def _vgg_features_state(features: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """JAX ``conv{li}_kernel`` (HWIO) and ``conv{li}_bias`` to torchvision's
    ``features.{i}.weight`` (OIHW) and ``.bias``, under ``prefix``."""
    from .eval.lpips import TORCH_CONV_IDX

    state: Dict[str, torch.Tensor] = {}
    for li, i in enumerate(TORCH_CONV_IDX):
        state[f"{prefix}{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(features[f"conv{li}_kernel"]).transpose(3, 2, 0, 1)))
        state[f"{prefix}{i}.bias"] = torch.from_numpy(np.array(features[f"conv{li}_bias"]))
    return state


def vgg16_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``eval.lpips.VGG16`` state dict for the JAX package's VGG16
    variables: the convolutions HWIO to OIHW; ``fc0_kernel`` (25088, 4096),
    whose rows run over the NHWC-flattened (7, 7, 512) pool, back to
    torchvision's ``classifier.0.weight`` (4096, 25088) over the
    NCHW-flattened pool; ``fc1_kernel`` transposed to ``classifier.3``."""
    params = variables["params"]
    state = _vgg_features_state(params["features"], "features.")
    w0 = np.asarray(params["fc0_kernel"]).reshape(7, 7, 512, 4096).transpose(3, 2, 0, 1)
    state["classifier.0.weight"] = torch.from_numpy(np.ascontiguousarray(w0.reshape(4096, -1)))
    state["classifier.0.bias"] = torch.from_numpy(np.array(params["fc0_bias"]))
    state["classifier.3.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["fc1_kernel"]).T))
    state["classifier.3.bias"] = torch.from_numpy(np.array(params["fc1_bias"]))
    return state


def lpips_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``eval.lpips.LPIPS`` state dict for the JAX package's LPIPS
    variables: the backbone (``net``) as in ``vgg16_variables_to_state_dict``,
    each head ``lin{i}_kernel`` (C, 1) to ``lin{i}.model.1.weight``
    (1, C, 1, 1)."""
    params = variables["params"]
    state = _vgg_features_state(params["net"], "net.")
    for i in range(5):
        k = np.asarray(params[f"lin{i}_kernel"])
        state[f"lin{i}.model.1.weight"] = torch.from_numpy(np.array(k.T.reshape(1, -1, 1, 1)))
    return state
