"""The class-conditional discriminators against the JAX package (CPU,
f32), through the helpers and bars of ``tests/test_torch_conditional.py``:
``CondSNDiscriminator`` at 32 and 48 px, ``FFCCondDiscriminator`` with and
without class-conditional FourierUnits, the cDCGAN discriminator with BN
and with spectral norm, its decaying input noise, and the all-FFC cDCGAN
discriminator, in training and in eval mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.conditional as jcond
import fastfourierconvolution_tpu_torch.models.conditional as tcond

from test_torch_conditional import (
    BATCH,
    CLASSES,
    LABELS,
    _bridge,
    _rel_check,
    check_discriminator,
    cond_variables,
)
from test_torch_ffc import nchw


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("resolution", [32, 48])
def test_cond_sn_discriminator_matches_jax(resolution, train):
    """The label plane and the 32px ladder (48px: its base, a 6x6 head),
    with the input-noise path taken at stddev 0."""
    jmodel = jcond.CondSNDiscriminator(num_classes=CLASSES, resolution=resolution,
                                       use_noise=True, noise_stddev=0.0)
    port = tcond.CondSNDiscriminator(num_classes=CLASSES, resolution=resolution,
                                     use_noise=True, noise_stddev=0.0)
    check_discriminator(jmodel, port, resolution, 3, train, seed=1)


@pytest.mark.parametrize("cond_spectral_bn", [False, True], ids=["plain-fu", "cond-fu"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ffc_cond_discriminator_matches_jax(train, cond_spectral_bn):
    """Labels taken modulo num_classes (one label out of range), biased
    leaky-ReLU FFC blocks with conditional BN, FourierUnits on (B, 16, 16,
    16) and (B, 32, 8, 8) (class-conditional with ``cond_spectral_bn``)."""
    jmodel = jcond.FFCCondDiscriminator(num_classes=CLASSES, noise_stddev=0.0,
                                        cond_spectral_bn=cond_spectral_bn, impl="dft")
    port = tcond.FFCCondDiscriminator(num_classes=CLASSES, noise_stddev=0.0,
                                      cond_spectral_bn=cond_spectral_bn)
    check_discriminator(jmodel, port, 32, 3, train, labels=np.array([3, 12, 7, 3]))


@pytest.mark.parametrize("use_sn", [False, True], ids=["bn", "sn"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cond_dcgan_discriminator_matches_jax(train, use_sn):
    """The label-plane stem and the doubling ladder with BN or with
    bias-free spectral-normed convolutions, ndf 32 (32px images)."""
    jmodel = jcond.CondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_sn=use_sn)
    port = tcond.CondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_sn=use_sn)
    check_discriminator(jmodel, port, 32, 1, train)


def test_cond_dcgan_discriminator_noise_decays_with_progress(monkeypatch):
    """With ``use_noise`` the image gets 0.1·0.01^progress times the same
    N(0, 1) draw on both sides, here at progress 0.5."""
    noise = np.random.default_rng(3).normal(size=(BATCH, 32, 32, 1)).astype(np.float32)
    jmodel = jcond.CondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_noise=True)
    port = tcond.CondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_noise=True)
    x = np.random.default_rng(0).uniform(-1, 1, size=(BATCH, 32, 32, 1)).astype(np.float32)
    y = jnp.asarray(LABELS)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    variables = cond_variables(jax.eval_shape(lambda v: jmodel.init(rngs, v, True, y),
                                              jnp.asarray(x)), 1)
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: (
        jnp.asarray(noise) if tuple(shape) == noise.shape else normal(key, shape, *a, **k)))
    monkeypatch.setattr(tcond, "draw_input_noise", lambda x, g: nchw(noise))
    out, _ = jmodel.apply(variables, jnp.asarray(x), True, y, 0.5, rngs=rngs,
                          mutable=["batch_stats"])
    _bridge(port, variables).train()
    ours = port(nchw(x), torch.float32, torch.from_numpy(LABELS), torch.Generator(),
                progress=torch.tensor(0.5))
    _rel_check(ours.detach().numpy(), out, "outputs")
    quiet = port(nchw(x), torch.float32, torch.from_numpy(LABELS), torch.Generator(),
                 progress=torch.tensor(1.0))
    assert (quiet - ours).abs().max() > 0


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ffc_cond_dcgan_discriminator_matches_jax(train):
    """GELU stems, the label plane, FFC blocks with ratio 0.5 and a
    sigmoid FFC head, ndf 32 (32px images, a FourierUnit on (B, 64, 4, 4))."""
    jmodel = jcond.FFCCondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, impl="dft")
    port = tcond.FFCCondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES)
    check_discriminator(jmodel, port, 32, 1, train)
