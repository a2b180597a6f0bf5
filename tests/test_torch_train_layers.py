"""The port's training-mode layers against the JAX package (CPU, f32).

BatchNorm with batch statistics, spectral normalisation and the SN
layers, the hinge losses and noise injection. Variables reach the port
through the bridge; inputs are numpy arrays from a seed, NHWC to JAX and
NCHW to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.nn import layers as jlayers
from fastfourierconvolution_tpu.ops import spectral_norm as jsn
from fastfourierconvolution_tpu.train import losses as jlosses
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn.layers import (
    BatchNorm,
    NoiseInjection,
    SNConv2d,
    SNDense,
)
from fastfourierconvolution_tpu_torch.ops import spectral_norm as tsn
from fastfourierconvolution_tpu_torch.train import losses as tlosses

from test_torch_ffc import nchw, nhwc


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def test_batchnorm_train_matches_flax_over_two_calls():
    """Outputs of two training calls and the running statistics after
    them (momentum 0.9, biased variance): 1e-5 absolute."""
    rng = np.random.default_rng(0)
    xs = [_f32(rng.normal(0.5, 2.0, size=(4, 6, 6, 5))) for _ in range(2)]
    jbn = jlayers.BatchNorm()
    variables = {
        "params": {"BatchNorm_0": {"scale": _f32(1 + 0.1 * rng.normal(size=5)),
                                   "bias": _f32(0.1 * rng.normal(size=5))}},
        "batch_stats": {"BatchNorm_0": {"mean": _f32(0.1 * rng.normal(size=5)),
                                        "var": _f32(rng.uniform(0.5, 1.5, size=5))}},
    }
    bn = BatchNorm(5)
    bn.load_state_dict(jax_to_state_dict(bn, variables["params"], variables["batch_stats"]))
    bn.train()
    for x in xs:
        y_j, upd = jbn.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        y_t = bn(nchw(x))
        np.testing.assert_allclose(nhwc(y_t.detach()), np.asarray(y_j), atol=1e-5)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)


def test_power_iteration_matches_jax():
    """sigma, the new u and v from one iteration: 1e-6 absolute."""
    rng = np.random.default_rng(1)
    w = _f32(rng.normal(size=(6, 10)))
    u = rng.normal(size=6)
    u = _f32(u / np.linalg.norm(u))
    s_j, u_j, v_j = jsn.power_iteration(jnp.asarray(w), jnp.asarray(u))
    s_t, u_t, v_t = tsn.power_iteration(torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_allclose(s_t.item(), float(s_j), rtol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)


@pytest.mark.parametrize("update", [True, False])
def test_spectral_normalize_conv_kernel_matches_jax(update):
    """An HWIO kernel in the JAX view and its OIHW copy in torch's differ
    by a column permutation only: same w / sigma and u, 1e-6 absolute."""
    rng = np.random.default_rng(2)
    k = _f32(rng.normal(size=(3, 3, 4, 6)))
    u = _f32(rng.normal(size=6))
    w_j, u_j = jsn.spectral_normalize(jnp.asarray(k), jnp.asarray(u), update)
    w_t, u_t = tsn.spectral_normalize(
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(u), update
    )
    np.testing.assert_allclose(w_t.numpy().transpose(2, 3, 1, 0), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-6)


def _jax_sn_layer(module, x, seed):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), True)
    rng = np.random.default_rng(seed)
    params = dict(variables["params"], bias=_f32(rng.normal(0, 0.1, size=variables["params"]["bias"].shape)))
    return {"params": params, "spectral": variables["spectral"]}


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_sn_layers_match_jax_in_train_and_eval(kind):
    """A training forward (one power iteration, u stored) and then an eval
    forward (stored u, no update): outputs to 1e-5 absolute, u to 1e-6."""
    rng = np.random.default_rng(3)
    if kind == "conv":
        x = _f32(rng.normal(size=(2, 8, 8, 4)))
        jmod, tmod = jlayers.SNConv2d(6, 3, stride=2, padding=1), SNConv2d(4, 6, 3, stride=2, padding=1)
        to_port, from_port = nchw, lambda t: nhwc(t.detach())
    else:
        x = _f32(rng.normal(size=(4, 10)))
        jmod, tmod = jlayers.SNDense(3), SNDense(10, 3)
        to_port, from_port = torch.from_numpy, lambda t: t.detach().numpy()
    variables = _jax_sn_layer(jmod, x, seed=4)
    tmod.load_state_dict(jax_to_state_dict(tmod, variables["params"], spectral=variables["spectral"]))

    y_j, upd = jmod.apply(variables, jnp.asarray(x), True, mutable=["spectral"])
    y_t = tmod.train()(to_port(x))
    np.testing.assert_allclose(from_port(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(tmod.u.numpy(), np.asarray(upd["spectral"]["u"]), atol=1e-6)
    assert not np.allclose(np.asarray(upd["spectral"]["u"]), np.asarray(variables["spectral"]["u"]))

    variables = {"params": variables["params"], **upd}
    y_j = jmod.apply(variables, jnp.asarray(x), False)
    u_before = tmod.u.clone()
    y_t = tmod.eval()(to_port(x))
    np.testing.assert_allclose(from_port(y_t), np.asarray(y_j), atol=1e-5)
    assert torch.equal(tmod.u, u_before)


def test_hinge_losses_match_jax():
    rng = np.random.default_rng(5)
    fake, real = (_f32(rng.normal(size=(8, 1)) * 2) for _ in range(2))
    np.testing.assert_allclose(
        tlosses.hinge_loss_dis(torch.from_numpy(fake), torch.from_numpy(real)).item(),
        float(jlosses.hinge_loss_dis(jnp.asarray(fake), jnp.asarray(real))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        tlosses.hinge_loss_gen(torch.from_numpy(fake)).item(),
        float(jlosses.hinge_loss_gen(jnp.asarray(fake))), rtol=1e-6,
    )
    with pytest.raises(ValueError, match="B, 1"):
        tlosses.hinge_loss_gen(torch.zeros(8))


def test_noise_injection_with_given_noise_matches_jax():
    """The JAX module draws its own noise; a unit-weight call on zeros
    reads that draw back, and the port gets it as the given noise. 1e-6."""
    rng = np.random.default_rng(6)
    x = _f32(rng.normal(size=(3, 5, 5, 4)))
    weight = _f32(rng.normal(size=(1, 1, 1, 4)))
    jmod, rngs = jlayers.NoiseInjection(), {"noise": jax.random.PRNGKey(7)}
    noise = np.array(jmod.apply(
        {"params": {"weight": np.ones((1, 1, 1, 1), np.float32)}},
        jnp.zeros((3, 5, 5, 1)), rngs=rngs,
    ))
    y_j = jmod.apply({"params": {"weight": weight}}, jnp.asarray(x), rngs=rngs)
    tmod = NoiseInjection(4)
    tmod.load_state_dict(jax_to_state_dict(tmod, {"weight": weight}))
    y_t = tmod(nchw(x), nchw(noise))
    np.testing.assert_allclose(nhwc(y_t.detach()), np.asarray(y_j), atol=1e-6)
