"""The SNGAN-ResNet models (``models/sngan_resnet.py``) and the resampling
ops they run against the JAX package (CPU, f32).

- ``upsample_bilinear_torch`` (two products with the bilinear weights)
  against ``F.interpolate(mode="bilinear", align_corners=False)`` and the
  JAX version at odd sizes (5x7), 1e-5 absolute; ``avg_pool2d`` against
  the JAX version.
- ``GBlock`` with and without class-conditional BN, ``DBlock`` (with and
  without its downsample), ``DBlockOptimized``, and both ladders (32px, 3
  blocks; 128px, 5 blocks, channels halving) at narrow widths, in training
  and eval mode, as ``tests/test_torch_dcgan.py`` holds its models.
- The ``resnet32`` preset's training settings (hinge, AdamW 0/0.9,
  separate D passes) on a narrow pair (ngf = ndf 16, z 16) in 2-step
  lockstep with the JAX ``GANTrainer`` (``check_pair_lockstep``). Every
  convolution bias of the generator's blocks is free there: a per-channel
  constant passes the bilinear upsample and the 1x1 shortcuts unchanged
  (up to a linear map) and every path ends in a BatchNorm, which removes
  it, so their gradient is 0 up to rounding.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fastfourierconvolution_tpu.models.sngan_resnet as jres
import fastfourierconvolution_tpu_torch.models.sngan_resnet as tres
from fastfourierconvolution_tpu.ops import conv as jconv
from fastfourierconvolution_tpu_torch.ops import conv as tconv

from test_torch_conditional import cond_variables
from test_torch_dcgan import (
    IMAGE_TOL,
    bridge_shapes,
    check_discriminator,
    check_generator,
    check_pair_lockstep,
    images,
    latents,
    run_both,
)
from test_torch_ffc import nchw, nhwc

TRAIN = [True, False]
TRAIN_IDS = ["train", "eval"]


def test_upsample_bilinear_matches_interpolate_and_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7)).astype(np.float32)
    ours = tconv.upsample_bilinear_torch(torch.from_numpy(x), 2)
    want = F.interpolate(torch.from_numpy(x), scale_factor=2, mode="bilinear",
                         align_corners=False)
    assert ours.shape == (2, 3, 10, 14)
    np.testing.assert_allclose(ours.numpy(), want.numpy(), atol=1e-5)
    theirs = jconv.upsample_bilinear_torch(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-5)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 3)).astype(np.float32)
    ours = tconv.avg_pool2d(nchw(x))
    np.testing.assert_allclose(nhwc(ours), np.asarray(jconv.avg_pool2d(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("train", TRAIN, ids=TRAIN_IDS)
@pytest.mark.parametrize("conditional", [False, True], ids=["bn", "cond-bn"])
@pytest.mark.parametrize("upsample,out_ch", [(True, 8), (False, 16)], ids=["up", "identity-sc"])
def test_gblock_matches_jax(upsample, out_ch, conditional, train):
    """The upsampling block with its learnable shortcut, and the block that
    keeps its shape (identity shortcut); plain or class-conditional BN."""
    x = images(8, 16)
    y = np.array([3, 0, 7, 3])
    classes = 10 if conditional else 0
    jblock = jres.GBlock(out_ch, upsample=upsample, num_classes=classes)
    port = tres.GBlock(16, out_ch, upsample=upsample, num_classes=classes)
    assert (port.c_sc is None) == (not upsample)
    args = (x, y) if conditional else (x,)
    out, ours = run_both(
        jblock, port, args,
        lambda m: m(nchw(x), torch.from_numpy(y) if conditional else None), train, 1,
        variables_fn=cond_variables)
    np.testing.assert_allclose(nhwc(ours), np.asarray(out), atol=IMAGE_TOL)


@pytest.mark.parametrize("train", TRAIN, ids=TRAIN_IDS)
@pytest.mark.parametrize("kind", ["optimized", "down", "same"])
def test_dblocks_match_jax(kind, train):
    """DBlockOptimized (pool before its 1x1), DBlock with its downsample (1x1
    before the pool) and without (identity shortcut)."""
    if kind == "optimized":
        x, jblock, port = images(8, 3), jres.DBlockOptimized(16), tres.DBlockOptimized(3, 16)
    elif kind == "down":
        x, jblock, port = images(8, 8), jres.DBlock(16, downsample=True), tres.DBlock(8, 16, downsample=True)
    else:
        x, jblock, port = images(8, 16), jres.DBlock(16), tres.DBlock(16, 16)
        assert port.c_sc is None
    out, ours = run_both(jblock, port, (x,), lambda m: m(nchw(x)), train, 2)
    np.testing.assert_allclose(nhwc(ours), np.asarray(out), atol=IMAGE_TOL)


@pytest.mark.parametrize("train", TRAIN, ids=TRAIN_IDS)
@pytest.mark.parametrize("blocks,resolution,ngf", [(3, 32, 16), (5, 128, 32)],
                         ids=["32px", "128px"])
def test_sngan_ladders_match_jax(blocks, resolution, ngf, train):
    """The generator and the discriminator of each ladder (the 128px one's
    channels halving each block: ngf ... ngf/16, ndf/16 ... ndf)."""
    jg = jres.SNGANGenerator(nz=16, ngf=ngf, num_blocks=blocks)
    port_g = tres.SNGANGenerator(nz=16, ngf=ngf, num_blocks=blocks)
    if blocks == 5:
        assert port_g.block6.c2.weight.shape[0] == ngf // 16
    check_generator(jg, port_g, latents(16), train)
    check_discriminator(jres.SNGANDiscriminator(ndf=ngf, num_blocks=blocks),
                        tres.SNGANDiscriminator(ndf=ngf, num_blocks=blocks),
                        images(resolution), train)


@pytest.mark.parametrize("name", ["sngan_generator_128", "sngan_discriminator_128",
                                  "sngan_generator_32", "sngan_discriminator_32"])
def test_factories_build_the_jax_models(name):
    """Each factory at its full width: the JAX factory's variables (shapes
    only) fill every tensor of the port factory's model."""
    jm, port = getattr(jres, name)(), getattr(tres, name)()
    x = latents(jm.nz)[:1] if "generator" in name else images(128 if "128" in name else 32)[:1]
    bridge_shapes(jm, port, x)


def test_resnet32_settings_in_lockstep_with_jax(monkeypatch):
    check_pair_lockstep(
        jres.SNGANGenerator(nz=16, ngf=16, num_blocks=3),
        jres.SNGANDiscriminator(ndf=16, num_blocks=3),
        tres.SNGANGenerator(nz=16, ngf=16, num_blocks=3),
        tres.SNGANDiscriminator(ndf=16, num_blocks=3),
        dict(b1=0.0, b2=0.9), 32, 16,
        free=r"g\.block[2-4]\.(c1|c2|c_sc)\.bias",
        fed_mean=r"g\.block[2-4]\.b2\.running_mean|g\.block[34]\.b1\.running_mean"
                 r"|g\.b_out\.running_mean",
        monkeypatch=monkeypatch)
