"""The SAGAN models (``models/sagan.py``) and their layers against the JAX
package (CPU, f32), as ``tests/test_torch_dcgan.py`` holds its models.

- ``SNConvTranspose2d`` with cin != out (its ``u`` runs over the 12 input
  channels): the output and, after a training forward, the new ``u``; the
  eval forward from the stored ``u``; 1e-5 absolute.
- ``SelfAttention``: ``out`` and ``attn`` at the seeded gamma (about 0.1,
  which would hide an error in the attention branch inside the bar) and at
  gamma 1; 1e-5 absolute.
- ``SAGANGenerator`` and ``SAGANDiscriminator`` at 32 and 64px (narrow:
  z 16, conv_dim 16), training and eval: images 1e-4 absolute, logits 1e-5
  of their largest, both attention maps 1e-5 absolute, statistics and
  ``u`` 1e-5.
- The ``sagan`` preset's training settings (wgan-gp, Adam 0/0.9, lr 1e-4,
  D lr 4e-4, 5 D updates, D first, separate passes) on the narrow 32px pair
  in 2-step lockstep with the JAX ``GANTrainer`` (``check_pair_lockstep``),
  both pairs through the zoo's ``TupleHeadWrapper``, both gammas set to 0.5
  at the start so that the attention branches carry the signal. Free
  biases there (gradient 0 up to rounding): the generator's SN ConvT
  biases, which feed BatchNorm alone; each attention's key bias, which adds
  a constant over the keys to the energy and leaves the softmax as it is;
  and the discriminator's value bias and head bias, whose per-channel
  constants reach the logits as one constant, which the wgan loss cancels
  between the real and fake means and the penalty's input gradient does
  not see.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.sagan as jsagan
import fastfourierconvolution_tpu.nn.layers as jlayers
import fastfourierconvolution_tpu.zoo as jzoo
import fastfourierconvolution_tpu_torch.models.sagan as tsagan
from fastfourierconvolution_tpu_torch import TupleHeadWrapper
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn.layers import SelfAttention, SNConvTranspose2d

from test_torch_dcgan import (
    IMAGE_TOL,
    LOGIT_TOL,
    RNGS,
    check_pair_lockstep,
    images,
    latents,
    rel_max,
    run_both,
)
from test_torch_ffc import nchw, nhwc, seeded_variables

LAYER_TOL = 1e-5
ATTN_TOL = 1e-5
TRAIN = [True, False]
TRAIN_IDS = ["train", "eval"]


def _set_gammas(value):
    def edit(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, v: np.full_like(np.asarray(v), value) if path[-1].key == "gamma" else v,
            params)
    return edit


@pytest.mark.parametrize("train", TRAIN, ids=TRAIN_IDS)
@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1)], ids=["stem", "up"])
def test_sn_conv_transpose_matches_jax(stride, padding, train):
    x = images(5, 12)
    jm = jlayers.SNConvTranspose2d(7, 4, stride=stride, padding=padding)
    port = SNConvTranspose2d(12, 7, 4, stride=stride, padding=padding)
    assert port.u.shape == (12,)
    out, ours = run_both(jm, port, (x,), lambda m: m(nchw(x)), train, 3)
    assert ours.shape == ((4, 7, 8, 8) if stride == 1 else (4, 7, 10, 10))
    np.testing.assert_allclose(nhwc(ours), np.asarray(out), atol=LAYER_TOL)


@pytest.mark.parametrize("gamma", [None, 1.0], ids=["seeded-gamma", "gamma-1"])
def test_self_attention_matches_jax(gamma):
    x = images(6, 16)
    jm = jlayers.SelfAttention()
    shapes = jax.eval_shape(lambda a: jm.init(RNGS, a), jnp.asarray(x))
    variables = seeded_variables(shapes, 4)
    if gamma is not None:
        variables["params"]["gamma"] = np.float32(gamma)
    (out, attn) = jm.apply(variables, jnp.asarray(x))
    port = SelfAttention(16)
    port.load_state_dict(jax_to_state_dict(port, variables["params"]))
    with torch.no_grad():
        ours, ours_attn = port(nchw(x))
    assert ours_attn.shape == (4, 36, 36) and ours_attn.dtype == torch.float32
    np.testing.assert_allclose(ours_attn.numpy(), np.asarray(attn), atol=ATTN_TOL)
    np.testing.assert_allclose(nhwc(ours), np.asarray(out), atol=LAYER_TOL)
    if gamma is not None:  # the attention product itself, not the residual
        assert np.abs(nhwc(ours) - x).max() > 0.05


@pytest.mark.parametrize("train", TRAIN, ids=TRAIN_IDS)
@pytest.mark.parametrize("resolution", [32, 64])
def test_sagan_pair_matches_jax(resolution, train):
    z = latents(16)
    (img, attn), (ours, ours_attn) = run_both(
        jsagan.SAGANGenerator(image_size=resolution, z_dim=16, conv_dim=16),
        tsagan.SAGANGenerator(image_size=resolution, z_dim=16, conv_dim=16), (z,),
        lambda m: m(torch.from_numpy(z), torch.float32, torch.Generator()), train, 1,
        edit=lambda v: {**v, "params": _set_gammas(1.0)(v["params"])})
    np.testing.assert_allclose(nhwc(ours), np.asarray(img), atol=IMAGE_TOL)
    assert np.asarray(img).std() > 0.01
    n = (resolution // 2) ** 2
    assert ours_attn.shape == (4, n, n)
    np.testing.assert_allclose(ours_attn.numpy(), np.asarray(attn), atol=ATTN_TOL)

    x = images(resolution)
    (logits, attn), (ours, ours_attn) = run_both(
        jsagan.SAGANDiscriminator(image_size=resolution, conv_dim=16),
        tsagan.SAGANDiscriminator(image_size=resolution, conv_dim=16), (x,),
        lambda m: m(nchw(x), torch.float32), train, 2,
        edit=lambda v: {**v, "params": _set_gammas(1.0)(v["params"])})
    assert ours.shape == (4, 1)
    assert rel_max(ours.numpy(), logits) <= LOGIT_TOL
    np.testing.assert_allclose(ours_attn.numpy(), np.asarray(attn), atol=ATTN_TOL)


def test_sagan_settings_in_lockstep_with_jax(monkeypatch):
    options = dict(loss="wgan-gp", optimizer="adam", b1=0.0, b2=0.9, lr=1e-4, d_lr=4e-4,
                   num_dis_updates=5, update_order="d_first", fused_dis_batch=False)
    check_pair_lockstep(
        jzoo.TupleHeadWrapper(jsagan.SAGANGenerator(image_size=32, z_dim=16, conv_dim=16)),
        jzoo.TupleHeadWrapper(jsagan.SAGANDiscriminator(image_size=32, conv_dim=16)),
        TupleHeadWrapper(tsagan.SAGANGenerator(image_size=32, z_dim=16, conv_dim=16)),
        TupleHeadWrapper(tsagan.SAGANDiscriminator(image_size=32, conv_dim=16)),
        options, 32, 16,
        free=r"g\.module\.(l[1-3]_conv|attn2\.key)\.bias"
             r"|d\.module\.(attn1\.key|attn1\.value|last)\.bias",
        fed_mean=r"g\.module\.l[1-3]_bn\.running_mean", edit=_set_gammas(0.5),
        monkeypatch=monkeypatch)
