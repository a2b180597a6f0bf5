"""Turn the JAX package's variables into the port's state dict.

Input: the JAX model's ``params``, ``batch_stats`` and ``spectral``
collections as nested dicts of numpy arrays (``jax.device_get`` of the
flax variables). Output: a state dict for the port's module, in torch
layouts:

- convolution HWIO -> OIHW (spectral-normed ones too);
- transposed convolution: the JAX kernel is HWIO and spatially flipped,
  torch's is IOHW, so ``w_t[i, o, a, b] = w_j[k-1-a, k-1-b, i, o]``;
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
  ``Conv2d_1``, ``Conv2d_2``) and the scalar ``gamma``.

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
buffer filled; anything else raises.
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
    convt = lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1)
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


def jax_to_state_dict(
    model: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None,
    spectral: Optional[Mapping] = None,
) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` from the JAX variables of the same model."""
    leaves = {
        "params": _flatten(params),
        "batch_stats": _flatten(batch_stats or {}),
        "spectral": _flatten(spectral or {}),
    }
    consumed = {name: set() for name in leaves}
    state: Dict[str, torch.Tensor] = {}
    expected = model.state_dict()
    jax_paths = _jax_paths(model)
    for name, module in model.named_modules():
        for attr, collection, suffix, convert in _leaf_rules(module):
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
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port entries the JAX variables do not fill: {missing}")
    return state
