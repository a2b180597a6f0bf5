"""The port's generator, bridge and server against the JAX package (CPU, f32).

Both packages run the same seeded variables (see test_torch_ffc's
``seeded_variables``) on the same numpy latents, in eval mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.models import FFCGenerator as JFFCGenerator
from fastfourierconvolution_tpu.models.ffc_gan import to_uint8 as jto_uint8
from fastfourierconvolution_tpu_torch import FFCGenerator, Generator, to_uint8
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.models.ffc_gan import PRESETS

from test_torch_ffc import seeded_variables

NARROW = dict(z_size=32, ngf=16, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1))


def _jax_generator(cfg, batch, seed):
    jmodel = JFFCGenerator(**cfg)
    z = np.random.default_rng(seed).normal(size=(batch, cfg["z_size"])).astype(np.float32)
    shapes = jax.eval_shape(
        lambda z: jmodel.init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, z, True
        ),
        jnp.asarray(z),
    )
    return jmodel, seeded_variables(shapes, seed + 1), z


def _jax_images(jmodel, variables, z):
    return np.asarray(jax.jit(lambda v, z: jmodel.apply(v, z, False))(variables, z))


def _port_server(cfg, variables):
    model = FFCGenerator(**cfg)
    state = jax_to_state_dict(model, variables["params"], variables["batch_stats"])
    return Generator(model, state, device="cpu", dtype="f32")


def test_narrow_generator_matches_jax():
    """ngf 16, z 32, 32px: float images to 1e-4 absolute; uint8 images
    within 1 level (truncation can flip at a level boundary)."""
    jmodel, variables, z = _jax_generator(NARROW, batch=3, seed=10)
    y_j = _jax_images(jmodel, variables, z)
    server = _port_server(NARROW, variables)
    y_t = server.generate(z, uint8=False).numpy()
    assert y_t.shape == y_j.shape == (3, 32, 32, 3)
    assert y_j.std() > 0.1  # the comparison sees real images, not a flat 0
    np.testing.assert_allclose(y_t, y_j, atol=1e-4)

    u_j = np.asarray(jto_uint8(jnp.asarray(y_j)))
    u_t = server.generate(z).numpy()
    assert u_t.dtype == np.uint8 and u_t.shape == (3, 32, 32, 3)
    assert np.abs(u_t.astype(int) - u_j.astype(int)).max() <= 1


def test_full_width_32px_preset_bridge_and_output():
    """The flagship preset at full width: the bridge takes every JAX leaf
    once and fills every port entry (it raises otherwise), and batch 2
    gives the same float images to 1e-4 absolute."""
    cfg = dict(z_size=128, **PRESETS[32])
    jmodel, variables, z = _jax_generator(cfg, batch=2, seed=20)
    model = FFCGenerator.for_resolution(32)
    state = jax_to_state_dict(model, variables["params"], variables["batch_stats"])
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables))
    assert set(state) == set(model.state_dict())
    assert sum(t.numel() for t in state.values()) == n_jax
    y_j = _jax_images(jmodel, variables, z)
    y_t = Generator(model, state, device="cpu", dtype="f32").generate(z, uint8=False)
    assert y_j.std() > 0.1
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-4)


def test_bridge_rejects_leftover_and_missing_leaves():
    _, variables, _ = _jax_generator(NARROW, batch=1, seed=30)
    model = FFCGenerator(**NARROW)
    params = dict(variables["params"], extra={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="extra/kernel"):
        jax_to_state_dict(model, params, variables["batch_stats"])
    params = {k: v for k, v in variables["params"].items() if k != "to_rgb"}
    with pytest.raises(KeyError, match="to_rgb"):
        jax_to_state_dict(model, params, variables["batch_stats"])


def test_to_uint8_truncates_like_jax():
    x = np.linspace(-1.2, 1.2, 1001, dtype=np.float32)
    ours = to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jto_uint8(jnp.asarray(x))))

