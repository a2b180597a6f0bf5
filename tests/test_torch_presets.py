"""The port's model presets against the JAX package's (CPU, f32).

The 48 and 96px discriminators (the 32 and 64px ladders with a head of
side 6), the 256px pair (six generator blocks, a ten-layer discriminator
ladder), the discriminator without spectral norm over one-channel images,
and the generator's generic ``mg·2^n`` ladder. Variables come from the JAX
models' shapes with seeded values (test_torch_ffc's ``seeded_variables``)
and reach the port through the bridge; inputs are numpy arrays from a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.models import ffc_gan as jffc_gan
from fastfourierconvolution_tpu_torch import FFCGenerator, Generator, SNConvDiscriminator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

from test_torch_ffc import nchw, seeded_variables

# Logits of the same images, rel-max = max|port - JAX| / max|JAX|: both
# sides compute in f32 and differ only in the order of the convolutions'
# sums (oneDNN against XLA), about 1e-7 of the logits' scale.
LOGIT_TOL = 1e-5
# The generator's float images, absolute, as the 32px generator tests hold
# them: its FourierUnits take factor-form DFTs on both sides in f32.
IMAGE_TOL = 1e-4


def _variables(jmodel, x, seed):
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda x: jmodel.init(rngs, x, True), jnp.asarray(x))
    return seeded_variables(shapes, seed)


def _port(model, variables):
    model.load_state_dict(jax_to_state_dict(model, variables["params"],
                                            variables.get("batch_stats"),
                                            variables.get("spectral")))
    return model.eval()


def _rel_max(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _logits(jd, port_d, variables, images_nhwc):
    """(port, JAX) logits of the same NHWC images, eval mode (stored u)."""
    theirs = np.asarray(jd.apply(variables, jnp.asarray(images_nhwc), False))
    with torch.no_grad():
        ours = port_d(nchw(images_nhwc)).numpy()
    assert ours.shape == theirs.shape == (images_nhwc.shape[0], 1)
    return ours, theirs


def test_narrow_48px_pair_matches_jax():
    """A narrow 48px generator (mg 6, ngf 8) and the 48px discriminator
    (the 32px ladder, a 6 x 6 x 512 head), both from bridged JAX weights:
    the images to 1e-4 absolute, and the discriminator's logits of them
    within 1e-5 rel-max of JAX's."""
    cfg = dict(z_size=16, ngf=8)
    jg = jffc_gan.FFCGenerator.for_resolution(48, **cfg)
    z = np.random.default_rng(30).normal(size=(3, 16)).astype(np.float32)
    g_vars = _variables(jg, z, seed=31)
    images = np.asarray(jax.jit(lambda v, z: jg.apply(v, z, False))(g_vars, z))
    port_g = FFCGenerator.for_resolution(48, **cfg)
    state = jax_to_state_dict(port_g, g_vars["params"], g_vars["batch_stats"])
    ours = Generator(port_g, state, device="cpu", dtype="f32").generate(z, uint8=False).numpy()
    assert ours.shape == images.shape == (3, 48, 48, 3) and images.std() > 0.05
    np.testing.assert_allclose(ours, images, atol=IMAGE_TOL)

    jd = jffc_gan.SNConvDiscriminator.for_resolution(48)
    d_vars = _variables(jd, images, seed=32)
    port_d = _port(SNConvDiscriminator.for_resolution(48), d_vars)
    assert port_d.fc.weight.shape == (1, 6 * 6 * 512)
    for imgs in (images, ours):
        logits, ref = _logits(jd, port_d, d_vars, imgs)
        assert _rel_max(logits, ref) <= LOGIT_TOL


# The discriminator head's side at each preset resolution: mg x mg x 512.
HEAD_SIDE = {48: 6, 96: 6, 256: 4}


@pytest.mark.parametrize("resolution", [48, 96, 256])
def test_48_and_96px_presets_build_with_jax_shapes(resolution):
    """The full-width generator and discriminator presets (and the 256px
    pair, ``for_resolution(256)``): the bridge takes every JAX leaf once,
    each in the shape the port wants, and fills every port entry (it raises
    otherwise)."""
    z, images = np.zeros((2, 128), np.float32), np.zeros((2, resolution, resolution, 3), np.float32)
    for jmodel, model, x in (
        (jffc_gan.FFCGenerator.for_resolution(resolution), FFCGenerator.for_resolution(resolution), z),
        (jffc_gan.SNConvDiscriminator.for_resolution(resolution),
         SNConvDiscriminator.for_resolution(resolution), images),
    ):
        variables = _variables(jmodel, x, seed=resolution)
        state = jax_to_state_dict(model, variables["params"], variables.get("batch_stats"),
                                  variables.get("spectral"))
        assert set(state) == set(model.state_dict())
        assert sum(t.numel() for t in state.values()) == sum(
            np.size(a) for a in jax.tree_util.tree_leaves(variables))
    side = HEAD_SIDE[resolution]
    assert model.fc.weight.shape == (1, side * side * 512)


def test_narrow_256px_generator_matches_jax():
    """``for_resolution(256, z_size=32, ngf=16)`` (the 256px ladder, six
    blocks, ratio 0.5; packed as the JAX default from 128px) from bridged
    JAX weights, eval mode at batch 1: its five FourierUnit maps up to 256 x
    256 take the plain versions here, and the images are within 1e-4
    rel-max of JAX's."""
    cfg = dict(z_size=32, ngf=16)
    jg = jffc_gan.FFCGenerator.for_resolution(256, **cfg)
    z = np.random.default_rng(33).normal(size=(1, 32)).astype(np.float32)
    g_vars = _variables(jg, z, seed=34)
    images = np.asarray(jax.jit(lambda v, z: jg.apply(v, z, False))(g_vars, z))
    port_g = FFCGenerator.for_resolution(256, **cfg)
    state = jax_to_state_dict(port_g, g_vars["params"], g_vars["batch_stats"])
    ours = Generator(port_g, state, device="cpu", dtype="f32").generate(z, uint8=False).numpy()
    assert ours.shape == images.shape == (1, 256, 256, 3) and images.std() > 0.05
    assert _rel_max(ours, images) <= IMAGE_TOL


def test_discriminator_without_sn_over_one_channel_matches_jax():
    """``use_sn=False, in_channels=1``: plain convs with biases and a plain
    dense head; logits within 1e-5 rel-max of JAX's on the same images."""
    images = np.random.default_rng(40).uniform(-1, 1, size=(4, 32, 32, 1)).astype(np.float32)
    jd = jffc_gan.SNConvDiscriminator.for_resolution(32, use_sn=False, in_channels=1)
    variables = _variables(jd, images, seed=41)
    assert "spectral" not in variables
    port_d = _port(SNConvDiscriminator.for_resolution(32, use_sn=False, in_channels=1),
                   variables)
    assert port_d.conv0.weight.shape == (64, 1, 3, 3) and port_d.conv0.bias is not None
    logits, ref = _logits(jd, port_d, variables, images)
    assert _rel_max(logits, ref) <= LOGIT_TOL


@pytest.mark.parametrize("resolution,mg", [(8, 4), (16, 4), (512, 4), (24, 3), (8, 2)])
def test_generator_generic_ladder_matches_jax(resolution, mg):
    """Resolutions without a preset take ngf 64, ratio 0.25 and the last n
    mults of (4, 2, 1, 1, ...) for mg·2^n, as in the JAX package; the
    output channels follow ``out_channels``."""
    kw = {} if mg == 4 else {"mg": mg}
    jg = jffc_gan.FFCGenerator.for_resolution(resolution, out_channels=1, **kw)
    port_g = FFCGenerator.for_resolution(resolution, out_channels=1, **kw)
    assert (port_g.mg, port_g.ngf, port_g.channel_mults) == (jg.mg, jg.ngf, tuple(jg.channel_mults))
    assert port_g.resolution == resolution
    if resolution <= 16:
        with torch.no_grad():
            assert port_g.eval()(torch.zeros(1, 128)).shape == (1, 1, resolution, resolution)


@pytest.mark.parametrize("resolution,mg", [(40, 4), (2, 4), (12, 0)])
def test_generator_refuses_what_is_no_ladder(resolution, mg):
    """No preset and no mg·2^n: a ValueError, where the JAX package
    asserts."""
    with pytest.raises(ValueError, match="mg"):
        FFCGenerator.for_resolution(resolution, mg=mg)
