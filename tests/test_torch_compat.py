"""The reference-checkpoint converters (``compat.py``) against the JAX
package's, on the CPU in f32.

No reference checkpoint ships with the repository, so each case builds a
seeded state dict in the reference repo's layout from the keys and shapes
the JAX converters read: every leaf of the JAX model's variable tree is
mapped to the reference key and torch layout it is converted from
(:func:`reference_entry`). Then:

- the JAX converter turns the dict back into a tree with every leaf of the
  model's, in its shape (so the dict is complete);
- the port's converter gives the same tree, leaf for leaf, bit for bit;
- the port's model, loaded through ``compat.to_state_dict`` (the bridge),
  gives the JAX model's eval-mode outputs on the converted variables;
- a ``.pth`` file holding the FFCModel container
  (``{model_state_dict, optimizer_state_dict}``) converts as the bare dict.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.compat as jcompat
import fastfourierconvolution_tpu.models.conditional as jcond
from fastfourierconvolution_tpu.models import FFCGenerator as JFFCGenerator
from fastfourierconvolution_tpu.models import SNConvDiscriminator as JSNConvDiscriminator
from fastfourierconvolution_tpu_torch import (
    CondSNDiscriminator,
    FFCCondGenerator,
    FFCGenerator,
    SNConvDiscriminator,
    compat,
)

CLASSES = 3
BATCH = 3
# outputs within this fraction of their largest magnitude (f32, the two
# packages' sums in different orders)
TOL = 1e-4
GEN = dict(z_size=8, ngf=8, ratio_g=0.5, mg=4, channel_mults=(2, 1))
NARROW_LADDER = ((8, 3, 1), (8, 4, 2), (16, 3, 1), (16, 4, 2), (16, 3, 1), (16, 4, 2), (32, 3, 1))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _oihw(s):
    return (s[3], s[2], s[0], s[1])


def _iohw(s):
    return (s[2], s[3], s[0], s[1])


def reference_entry(path, shape, n_blocks, stem, cond_bn):
    """(reference key, torch shape) that the JAX converters read to make the
    leaf at ``path`` (collection first) of ``shape``. ``stem`` is the dense
    stem's key prefix; ``cond_bn`` the blocks whose BNs are
    class-conditional."""
    coll, *p = path
    if p[0] == "noise_to_feature":
        return f"{stem}.{p[1] if p[1] == 'bias' else 'weight'}", shape[::-1]
    if p[0] == "label_embed":
        return "label_embed.weight", shape
    if p[0] in ("label_conv", "input_conv"):
        return f"{p[0]}.0.{'weight' if p[1] == 'kernel' else 'bias'}", (
            _iohw(shape) if p[1] == "kernel" else shape)
    if p[0] in ("label_bn", "input_bn"):
        return f"{p[0][:-3]}_conv.1.{_bn_name(coll, p[-1])}", shape
    noise = re.fullmatch(r"(lcl|glb)_noise(\d+)", p[0])
    if noise:
        return f"{noise[1]}_noise{int(noise[2]) + 2}.weight", (1, shape[-1], 1, 1)
    if p[0].startswith("conv") or p[0] == "fc":  # the SN discriminators
        name = "fc" if p[0] == "fc" else f"conv{int(p[0][4:]) + 1}"
        if coll == "spectral":
            return f"{name}.weight_u", shape
        if p[1] == "bias":
            return f"{name}.bias", shape
        return f"{name}.weight_orig", shape[::-1] if p[0] == "fc" else _oihw(shape)
    block = p[0] == "to_rgb" or p[0].startswith("block")
    assert block, path
    i = n_blocks if p[0] == "to_rgb" else int(p[0][5:])
    prefix = f"conv{i + 2}"
    if p[1] in ("bn_l", "bn_g"):
        if p[0] in cond_bn:
            if coll == "batch_stats":
                return f"{prefix}.{p[1]}.bn.running_{p[-1]}", shape
            return f"{prefix}.{p[1]}.embed.weight", (shape[0], 2 * shape[1])
        return f"{prefix}.{p[1]}.{_bn_name(coll, p[-1])}", shape
    assert p[1] == "ffc", path
    if p[2] != "convg2g":
        return f"{prefix}.ffc.{p[2]}.weight", (_oihw if p[0] == "to_rgb" else _iohw)(shape)
    g2g = f"{prefix}.ffc.convg2g"
    if p[3] in ("Conv2d_0", "Conv2d_1"):
        return f"{g2g}.conv{int(p[3][-1]) + 1}.weight", _oihw(shape)
    if p[3] == "BatchNorm_0":
        return f"{g2g}.bn1.{_bn_name(coll, p[-1])}", shape
    if p[3] == "SELayer_0":
        return f"{g2g}.se_block.fc.{2 * int(p[4][-1])}.weight", shape[::-1]
    assert p[3] == "FourierUnit_0", path
    if p[-1] == "mix_kernel":
        return f"{g2g}.fu.conv_layer.weight", (*shape, 1, 1)
    return f"{g2g}.fu.bn.{_bn_name(coll, p[-1].replace('bn_', ''))}", shape


def _bn_name(coll, leaf):
    if coll == "batch_stats":
        return f"running_{leaf}"
    return {"scale": "weight", "bias": "bias"}[leaf]


def _paths(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(np.shape(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_dict(shapes, seed, stem="noise_to_feature.0"):
    """A seeded reference-layout state dict (torch tensors) covering every
    leaf of the JAX variable tree ``shapes``: weights N(0, 1/fan), BN
    weights (and a class-conditional BN's gamma half) 1 + N(0, 0.1),
    running variances U(0.5, 1.5), the rest N(0, 0.1)."""
    paths = _paths(shapes)
    n_blocks = len({p[1] for p in paths if p[1].startswith("block")})
    cond_bn = {p[1] for p in paths if p[-1] == "gamma"}
    entries = {}
    for path, shape in sorted(paths.items()):
        key, torch_shape = reference_entry(path, shape, n_blocks, stem, cond_bn)
        entries[key] = tuple(torch_shape)
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in entries.items():
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("embed.weight") and key != "label_embed.weight":
            half = shape[1] // 2
            v = np.concatenate([1 + rng.normal(0, 0.1, (shape[0], half)),
                                rng.normal(0, 0.1, (shape[0], half))], axis=1)
        elif key.endswith(".weight") and len(shape) == 1:
            v = 1 + rng.normal(0, 0.1, shape)
        elif key.endswith((".weight", ".weight_orig")) and len(shape) >= 2:
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape) / shape[0]), shape)
        else:
            v = rng.normal(0, 0.1, shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    return sd


def _gen_case(kind):
    if kind == "ffc":
        return (JFFCGenerator(**GEN), FFCGenerator(**GEN), jcompat.convert_fgan_generator,
                compat.convert_fgan_generator, "noise_to_feature.0")
    stem = "convt" if kind == "cond-convt" else "dense"
    kw = dict(GEN, num_classes=CLASSES, stem=stem)
    return (jcond.FFCCondGenerator(**kw), FFCCondGenerator(**kw),
            jcompat.convert_fcond_generator, compat.convert_fcond_generator, "noise_to_feature")


def _d_case(kind):
    if kind == "sn-d":
        return (JSNConvDiscriminator(ladder=NARROW_LADDER), SNConvDiscriminator(NARROW_LADDER),
                jcompat.convert_sn_discriminator, compat.convert_sn_discriminator)
    return (jcond.CondSNDiscriminator(num_classes=CLASSES), CondSNDiscriminator(CLASSES),
            jcompat.convert_cond_sn_discriminator, compat.convert_cond_sn_discriminator)


def _check_trees(shapes, j_vars, t_vars):
    """JAX's tree has every leaf of the model's in its shape; the port's
    is the same tree, bit for bit."""
    assert _paths(j_vars) == _paths(shapes)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(j_vars)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(t_vars)[0])
    assert flat_j.keys() == flat_t.keys()
    for path, leaf in flat_j.items():
        assert flat_t[path].dtype == np.float32, path
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf), err_msg=str(path))


def _close(ours, ref, what):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert np.abs(ref).max() > 0.01, what  # real outputs, not a flat 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("kind", ["ffc", "cond-convt", "cond-dense"])
def test_generator_converters_match_jax(kind, tmp_path):
    jmodel, port, jconvert, convert, stem = _gen_case(kind)
    cond = kind != "ffc"
    z = np.random.default_rng(1).normal(size=(BATCH, GEN["z_size"])).astype(np.float32)
    y = np.arange(BATCH) % CLASSES
    extra = (jnp.asarray(y),) if cond else ()
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jmodel.init(rngs, z, True, *extra), jnp.asarray(z))
    sd = reference_dict(shapes, seed=2, stem=stem)
    j_vars = jconvert(sd, mg=GEN["mg"])
    t_vars = convert(sd, mg=GEN["mg"])
    _check_trees(shapes, j_vars, t_vars)

    ref = jmodel.apply(j_vars, jnp.asarray(z), False, *extra)
    port.load_state_dict(compat.to_state_dict(port, t_vars))
    with torch.no_grad():
        args = (torch.from_numpy(z), torch.float32, None) + (
            (torch.from_numpy(y),) if cond else ())
        ours = port.eval()(*args).permute(0, 2, 3, 1).numpy()
    _close(ours, ref, kind)

    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 3}, path)
    _check_trees(shapes, j_vars, convert(path, mg=GEN["mg"]))


@pytest.mark.parametrize("kind", ["sn-d", "cond-sn-d"])
def test_discriminator_converters_match_jax(kind, tmp_path):
    jmodel, port, jconvert, convert = _d_case(kind)
    cond = kind == "cond-sn-d"
    x = np.random.default_rng(3).uniform(-1, 1, size=(BATCH, 32, 32, 3)).astype(np.float32)
    y = np.arange(BATCH) % CLASSES
    extra = (jnp.asarray(y),) if cond else ()
    rngs = {"params": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda x: jmodel.init(rngs, x, True, *extra), jnp.asarray(x))
    sd = reference_dict(shapes, seed=4)
    j_vars = jconvert(sd)
    t_vars = convert(sd)
    _check_trees(shapes, j_vars, t_vars)

    ref = jmodel.apply(j_vars, jnp.asarray(x), False, *extra)
    port.load_state_dict(compat.to_state_dict(port, t_vars))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        args = (xt, torch.float32) + ((torch.from_numpy(y),) if cond else ())
        ours = port.eval()(*args).numpy()
    _close(ours, ref, kind)

    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": sd}, path)
    _check_trees(shapes, j_vars, convert(path))


def test_unrecognised_checkpoints_are_refused():
    with pytest.raises(ValueError, match="unrecognised conditional-generator stem"):
        compat.convert_fcond_generator({"label_embed.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="unrecognised FGenerator keys"):
        compat.convert_fgan_generator({"noise_to_feature.0.weight": torch.zeros(64, 8),
                                       "noise_to_feature.0.bias": torch.zeros(64)})
