"""The port's ``GANTrainer`` options in lockstep with the JAX package's (CPU, f32).

Each case trains the narrow tuple pair of ``tests/test_torch_train_step.py``
(ngf 16, z 32, 32px, against a three-conv SN discriminator) for two steps at
batch 4 from the JAX ``GANTrainer.init`` variables, carried into the port by
the bridge, on the same real batches and latents (``zs``, one latent batch
for the G phase and one per D update). NoiseInjection is neutralised on
both sides, as there. wgan-gp draws its interpolation weights from each
side's generator; here both draws are patched to the same weights.

Bars, as in ``tests/test_torch_train_step.py``: the losses of each step
within 1e-3; after each step every parameter, running statistic and ``u``
of both models within 1e-4 (absolute), but for Adam's rounding-decided
steps (``ADAM_FLIP_SHARE``) and the all-FFC discriminator's free biases
(``FREE_BIAS``).

This file holds the D updates' count and passes;
``tests/test_torch_train_order.py`` the update order and the optimizer,
``tests/test_torch_train_losses.py`` the losses and
``tests/test_torch_sngan.py`` the sngan pair, through
:func:`check_lockstep`.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
import fastfourierconvolution_tpu_torch.models.ffc_gan as tffc_gan
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import (
    FFCDiscriminator,
    FFCGenerator,
    GANTrainer,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.train import losses as tlosses

from test_torch_generator import NARROW
from test_torch_train_step import HEAD, LADDER, LOSS_TOL, STATE_TOL, TOTAL_STEPS, _NoNoise, _no_noise

BATCH, STEPS = 4, 2
# wgan-gp's interpolation weights, one per item, on both sides.
GP_EPS = np.array([0.2, 0.5, 0.7, 0.9], np.float32).reshape(BATCH, 1, 1, 1)


def _d_models(kind):
    """(JAX discriminator, port discriminator) of ``kind``: "sn" the
    three-conv SN ladder, "ffc" the all-FFC discriminator."""
    if kind == "ffc":
        return jffc_gan.FFCDiscriminator(impl="dft"), FFCDiscriminator()
    return jffc_gan.SNConvDiscriminator(ladder=LADDER, mg=HEAD), SNConvDiscriminator(
        ladder=LADDER, head_size=HEAD)


def _data(n_dis):
    rng = np.random.default_rng(0)
    reals = rng.uniform(-1, 1, size=(STEPS, BATCH, 32, 32, 3)).astype(np.float32)
    zs = rng.normal(size=(STEPS, 1 + n_dis, BATCH, NARROW["z_size"])).astype(np.float32)
    return reals, zs


def _port_state(g, d):
    """Every parameter and buffer of the pair, keyed like its state dicts."""
    return {**{f"g.{k}": v for k, v in g.items()}, **{f"d.{k}": v for k, v in d.items()}}


def _jax_lockstep(options, d_kind):
    reals, zs = _data(options.get("num_dis_updates", 1))
    jd, port_d = _d_models(d_kind)
    port_g = FFCGenerator(**NARROW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        jg = jffc_gan.FFCGenerator(**NARROW, impl="dft")
        trainer = JGANTrainer(jg, jd, z_size=NARROW["z_size"], total_steps=TOTAL_STEPS,
                              **options)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        init = jax.device_get((state.g, state.d))
        # the penalty's only uniform draw; patched after init, whose dense
        # initialisers draw uniforms too
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(GP_EPS))
        step = jax.jit(trainer.update_step)
        losses, states = [], []
        for k in range(STEPS):
            state, metrics = step(state, jnp.asarray(reals[k]), zs=jnp.asarray(zs[k]))
            losses.append((float(metrics["loss_g"]), float(metrics["loss_d"])))
            g, d = jax.device_get((state.g, state.d))
            states.append(_port_state(
                jax_to_state_dict(port_g, g.params, g.batch_stats),
                jax_to_state_dict(port_d, d.params, d.batch_stats, d.spectral),
            ))
    return dict(init=init, losses=losses, states=states, reals=reals, zs=zs)


def _port_trainer(run, options, d_kind, monkeypatch):
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)
    monkeypatch.setattr(tlosses, "interpolation_weights",
                        lambda real, generator: torch.from_numpy(GP_EPS))
    g_init, d_init = run["init"]
    g, (_, d) = FFCGenerator(**NARROW), _d_models(d_kind)
    g.load_state_dict(jax_to_state_dict(g, g_init.params, g_init.batch_stats))
    d.load_state_dict(jax_to_state_dict(d, d_init.params, d_init.batch_stats, d_init.spectral))
    return GANTrainer(g, d, z_size=NARROW["z_size"], total_steps=TOTAL_STEPS, device="cpu",
                      dtype="f32", **options)


# FFCDiscriminator's convolution biases in blocks 1-3 feed BatchNorm, which
# subtracts them again: their gradient is 0 up to rounding, and Adam turns
# the rounding's sign into a step of about lr, on each side on its own. They
# carry no part of the losses, so they are left out of the comparison; the
# running mean of a BatchNorm they feed takes a 0.1 share of the bias per
# forward (under 1 in all), so it is held to the bar plus the largest gap
# between the two sides' free biases.
FREE_BIAS = re.compile(r"d\.block[1-3]\.ffc\.conv(l2l|l2g|g2l)\.bias")
FED_MEAN = re.compile(r"d\.block[1-3]\.bn_[lg]\.running_mean")
# Adam steps a parameter by about lr whatever the size of its gradient, so
# an element whose gradient is within rounding of 0 can step the other way
# on one side (one element of FFCDiscriminator's 1.5M-element block3 kernel
# did). Per parameter at most this share of its elements (at least one) may
# leave the bar, by no more than two learning rates per step taken.
ADAM_FLIP_SHARE = 1e-5


def _check_param(name, ours, ref, steps, lr):
    diff = np.abs(ours - ref)
    off = diff > STATE_TOL
    assert off.sum() <= max(1, ADAM_FLIP_SHARE * diff.size), (
        f"{name}: {off.sum()} of {diff.size} elements beyond {STATE_TOL}")
    assert diff.max() <= STATE_TOL + 2 * lr * steps, (name, diff.max())


def check_lockstep(options, monkeypatch, d_kind="sn"):
    """Two steps of the port's trainer with ``options`` against the JAX
    trainer's with the same options: losses and the whole state after each
    step (see ``FREE_BIAS``)."""
    run = _jax_lockstep(options, d_kind)
    trainer = _port_trainer(run, options, d_kind, monkeypatch)
    params = {f"{side}.{n}" for side, m in (("g", trainer.g), ("d", trainer.d))
              for n, _ in m.named_parameters()}
    lr = max(options.get("lr", 2e-4), options.get("d_lr") or 0.0)
    for k in range(STEPS):
        out = trainer.update_step(run["reals"][k], zs=run["zs"][k])
        ours = (out["loss_g"].item(), out["loss_d"].item())
        np.testing.assert_allclose(ours, run["losses"][k], atol=LOSS_TOL,
                                   err_msg=f"losses at step {k}")
        state = _port_state(trainer.g.state_dict(), trainer.d.state_dict())
        assert state.keys() == run["states"][k].keys()
        free_gap = max([(state[n] - ref).abs().max().item()
                        for n, ref in run["states"][k].items() if FREE_BIAS.fullmatch(n)],
                       default=0.0)
        for name, ref in run["states"][k].items():
            if FREE_BIAS.fullmatch(name):
                continue
            if name in params:
                _check_param(f"{name} after step {k}", state[name].numpy(), ref.numpy(), k + 1,
                             lr)
                continue
            tol = STATE_TOL + (free_gap if FED_MEAN.fullmatch(name) else 0.0)
            np.testing.assert_allclose(state[name].numpy(), ref.numpy(), atol=tol,
                                       err_msg=f"{name} after step {k}")
    assert trainer.step == STEPS


@pytest.mark.parametrize("options", [
    dict(num_dis_updates=2, fused_dis_batch=True),
    dict(fused_dis_batch=False),
], ids=["two-dis-updates", "unfused"])
def test_option_in_lockstep_with_jax(options, monkeypatch):
    check_lockstep(options, monkeypatch)
