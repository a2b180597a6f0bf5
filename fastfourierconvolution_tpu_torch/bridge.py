"""Turn the JAX package's variables into the port's state dict.

Input: the JAX model's ``params`` and ``batch_stats`` collections as
nested dicts of numpy arrays (``jax.device_get`` of the flax variables).
Output: a state dict for the port's module, in torch layouts:

- convolution HWIO -> OIHW;
- transposed convolution: the JAX kernel is HWIO and spatially flipped,
  torch's is IOHW, so ``w_t[i, o, a, b] = w_j[k-1-a, k-1-b, i, o]``;
- Dense (in, out) -> (out, in);
- FourierUnit ``mix_kernel`` (2C, 2C) as it is: both packages order the
  spectral channels [re; im];
- BatchNorm scale/bias/mean/var as they are.

Every JAX leaf must be consumed exactly once and every port parameter and
buffer filled; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from .nn.ffc import FourierUnit
from .nn.layers import BatchNorm, Conv2d, ConvTranspose2d, Dense, NoiseInjection

# Port child name -> the name flax gives the same submodule.
_JAX_CHILD_NAMES = {
    "se": "SELayer_0",
    "conv1": "Conv2d_0",
    "bn": "BatchNorm_0",
    "fu": "FourierUnit_0",
    "conv2": "Conv2d_1",
    "fc1": "Dense_0",
    "fc2": "Dense_1",
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


def _jax_path(module_name: str) -> Tuple[str, ...]:
    if not module_name:
        return ()
    return tuple(_JAX_CHILD_NAMES.get(p, p) for p in module_name.split("."))


def _leaf_rules(module: nn.Module):
    """(port attribute, collection, JAX leaf path suffix, converter)."""
    conv = lambda w: w.transpose(3, 2, 0, 1)
    convt = lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1)
    same = lambda w: w
    if isinstance(module, Conv2d):
        return [("weight", "params", ("kernel",), conv)]
    if isinstance(module, ConvTranspose2d):
        return [("weight", "params", ("kernel",), convt)]
    if isinstance(module, Dense):
        rules = [("weight", "params", ("kernel",), lambda w: w.T)]
        if module.bias is not None:
            rules.append(("bias", "params", ("bias",), same))
        return rules
    if isinstance(module, BatchNorm):
        return [
            ("weight", "params", ("BatchNorm_0", "scale"), same),
            ("bias", "params", ("BatchNorm_0", "bias"), same),
            ("running_mean", "batch_stats", ("BatchNorm_0", "mean"), same),
            ("running_var", "batch_stats", ("BatchNorm_0", "var"), same),
        ]
    if isinstance(module, FourierUnit):
        return [
            ("mix_kernel", "params", ("mix_kernel",), same),
            ("bn_scale", "params", ("bn_scale",), same),
            ("bn_bias", "params", ("bn_bias",), same),
            ("running_mean", "batch_stats", ("mean",), same),
            ("running_var", "batch_stats", ("var",), same),
        ]
    if isinstance(module, NoiseInjection):
        return [("weight", "params", ("weight",), lambda w: w.reshape(-1))]
    return []


def jax_to_state_dict(
    model: nn.Module, params: Mapping, batch_stats: Mapping
) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` from the JAX variables of the same model."""
    leaves = {
        "params": _flatten(params),
        "batch_stats": _flatten(batch_stats),
    }
    consumed = {"params": set(), "batch_stats": set()}
    state: Dict[str, torch.Tensor] = {}
    expected = model.state_dict()
    for name, module in model.named_modules():
        for attr, collection, suffix, convert in _leaf_rules(module):
            key = f"{name}.{attr}" if name else attr
            path = _jax_path(name) + suffix
            if path not in leaves[collection]:
                raise KeyError(f"{key}: no JAX leaf {collection}/{'/'.join(path)}")
            if path in consumed[collection]:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} used twice")
            consumed[collection].add(path)
            value = np.ascontiguousarray(convert(leaves[collection][path]))
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
