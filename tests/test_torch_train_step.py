"""The port's GAN training step in lockstep with the JAX package's (CPU, f32).

A narrow generator (ngf 16, z 32, 32px) and a three-conv SN discriminator
start from the JAX ``GANTrainer.init`` variables, carried into the port by
the bridge, and take three steps on the same latents and real batches.
The JAX generator runs with ``impl="dft"``, so its FourierUnit goes through
``fourier_unit_fused`` and its custom VJP, the function the port's kernels
implement.

NoiseInjection is neutralised on both sides, as ``tests/parity_ab.py``
does: its weights start at zero, but their gradient is the raw noise draw,
which two RNGs cannot share. The JAX module's name is patched in this test
with a module of the same parameter tree that adds nothing; the port's
noise draw is patched to zeros.

A second pair runs the same checks in packed-branch mode: a narrow
ratio-0.5 five-block generator (the 128px preset's ladder at ngf 8 and
mg 2, so 64px) against a four-conv discriminator, with the tanh-form GELU
forced on both sides, so the port's blocks go through the fused packed
BN + GELU op with the noise fold (its plain versions on the CPU) and the
JAX blocks through their packed path. The JAX package's packed noise
holder is neutralised like NoiseInjection.
"""

from __future__ import annotations

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
import fastfourierconvolution_tpu_torch.models.ffc_gan as tffc_gan
from fastfourierconvolution_tpu.nn import layers as jlayers
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import FFCGenerator, GANTrainer, SNConvDiscriminator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
import fastfourierconvolution_tpu_torch.nn.ffc as tffc
from fastfourierconvolution_tpu_torch.nn import layers as tlayers

from test_torch_ffc import seeded_variables
from test_torch_generator import NARROW

LADDER = ((16, 3, 1), (32, 4, 2), (32, 4, 2))  # 32 -> 32 -> 16 -> 8
HEAD = 8
# The packed pair: the 128px preset's ratio and channel ladder, narrow.
PACKED = dict(z_size=16, ngf=8, ratio_g=0.5, mg=2, channel_mults=(4, 2, 1, 1, 1))
PACKED_LADDER = ((8, 3, 1), (16, 4, 2), (16, 4, 2), (16, 4, 2))  # 64 -> 8
BATCH, STEPS, TOTAL_STEPS = 4, 3, 100
# Losses per step: the A/B bar of BASELINE.md ("Training-behavior A/B").
LOSS_TOL = 1e-3
# First-step gradients, per tensor, rel-max: f32 on both sides, the same
# math summed in other orders (XLA vs oneDNN convolutions, factor-form DFTs)
# through G and D.
GRAD_TOL = 1e-4
# Running statistics and u after each step, absolute: they move by a 0.1
# share of f32 batch statistics per call and by one power iteration.
STATE_TOL = 1e-4


class _NoNoise(fnn.Module):
    """NoiseInjection's parameter tree, adding nothing."""

    @fnn.compact
    def __call__(self, x):
        self.param("weight", fnn.initializers.zeros, (1, 1, 1, x.shape[-1]))
        return x


class _NoNoiseHolder(fnn.Module):
    """NoiseWeightHolder's parameter tree, drawing zeros."""

    features: int

    @fnn.compact
    def __call__(self, x):
        w = self.param("weight", fnn.initializers.zeros, (1, 1, 1, self.features))
        return w, jnp.zeros(x.shape[:3] + (1,), x.dtype)


@contextlib.contextmanager
def _fast_gelu(on: bool):
    """With ``on``, the tanh-form GELU for every dtype on both sides."""
    old = jlayers._FAST_GELU, tlayers._FAST_GELU
    if on:
        jlayers.set_fast_gelu(True)
        tlayers.set_fast_gelu(True)
    try:
        yield
    finally:
        jlayers._FAST_GELU, tlayers._FAST_GELU = old


def _count_fused(monkeypatch):
    """Records the channel count of every call of the port's fused op with
    the noise fold; returns the list it fills."""
    calls, op = [], tffc.packed_bn_gelu_noise

    def counted(x, *args):
        calls.append(x.shape[1])
        return op(x, *args)

    monkeypatch.setattr(tffc, "packed_bn_gelu_noise", counted)
    return calls


def _no_noise(x, generator):
    b, _, h, w = x.shape
    return torch.zeros((b, 1, h, w), dtype=x.dtype, device=x.device)


def _data(g_cfg, resolution):
    rng = np.random.default_rng(0)
    reals = rng.uniform(-1, 1, size=(STEPS, BATCH, resolution, resolution, 3))
    zs = rng.normal(size=(STEPS, 2, BATCH, g_cfg["z_size"]))
    return reals.astype(np.float32), zs.astype(np.float32)


def _port_state(trainer_state):
    """Running statistics of G and the u vectors of D, keyed like the
    port's state dicts."""
    g, d = trainer_state
    return {
        **{f"g.{k}": v for k, v in g.items() if "running" in k},
        **{f"d.{k}": v for k, v in d.items() if k.endswith(".u")},
    }


def _jax_lockstep(pair):
    """The JAX trainer's initial variables, first-step G gradients, and
    per-step losses and state of ``pair``, in the port's layouts."""
    g_cfg, ladder, head, resolution, packed = PAIRS[pair]
    reals, zs = _data(g_cfg, resolution)
    with pytest.MonkeyPatch.context() as mp, _fast_gelu(packed):
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        mp.setattr(jffc_gan, "NoiseWeightHolder", _NoNoiseHolder)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        jg = jffc_gan.FFCGenerator(**g_cfg, impl="dft", packed=packed)
        jd = jffc_gan.SNConvDiscriminator(ladder=ladder, mg=head)
        trainer = JGANTrainer(jg, jd, z_size=g_cfg["z_size"], total_steps=TOTAL_STEPS,
                              fused_dis_batch=True)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        init = jax.device_get((state.g.params, state.g.batch_stats,
                               state.d.params, state.d.spectral))

        def g_loss(params):
            fake, _ = trainer._apply_g(
                {"params": params, "batch_stats": state.g.batch_stats},
                jnp.asarray(zs[0, 0]), jax.random.PRNGKey(1),
            )
            logits, _ = trainer._apply_d(
                {"params": state.d.params, "spectral": state.d.spectral}, fake
            )
            return trainer.gen_loss(logits)

        grads = jax.device_get(jax.jit(jax.grad(g_loss))(state.g.params))
        step = jax.jit(trainer.update_step)
        losses, states = [], []
        for k in range(STEPS):
            state, metrics = step(state, jnp.asarray(reals[k]), zs=jnp.asarray(zs[k]))
            losses.append((float(metrics["loss_g"]), float(metrics["loss_d"])))
            g_stats, d_u = jax.device_get((state.g.batch_stats, state.d.spectral))
            states.append(_port_state((
                jax_to_state_dict(_port_g(pair), state.g.params, g_stats),
                jax_to_state_dict(_port_d(pair), state.d.params, spectral=d_u),
            )))
    return dict(pair=pair, init=init, grads=grads, losses=losses, states=states,
                reals=reals, zs=zs)


# name -> (generator config, D ladder, D head size, resolution, packed)
PAIRS = {
    "tuple": (NARROW, LADDER, HEAD, 32, False),
    "packed": (PACKED, PACKED_LADDER, 8, 64, True),
}


@pytest.fixture(scope="module")
def jax_run():
    return _jax_lockstep("tuple")


@pytest.fixture(scope="module")
def jax_run_packed():
    return _jax_lockstep("packed")


def _port_g(pair):
    g_cfg, _, _, _, packed = PAIRS[pair]
    return FFCGenerator(**g_cfg, packed=packed)


def _port_d(pair):
    _, ladder, head, _, _ = PAIRS[pair]
    return SNConvDiscriminator(ladder=ladder, head_size=head)


def _port_trainer(run, monkeypatch):
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)
    g_params, g_stats, d_params, d_u = run["init"]
    g, d = _port_g(run["pair"]), _port_d(run["pair"])
    g.load_state_dict(jax_to_state_dict(g, g_params, g_stats))
    d.load_state_dict(jax_to_state_dict(d, d_params, spectral=d_u))
    return GANTrainer(g, d, z_size=PAIRS[run["pair"]][0]["z_size"],
                      total_steps=TOTAL_STEPS, fused_dis_batch=True, device="cpu", dtype="f32")


def test_first_step_generator_gradients_match_jax(jax_run, monkeypatch):
    _check_first_step_gradients(jax_run, monkeypatch)


def _check_first_step_gradients(jax_run, monkeypatch):
    trainer = _port_trainer(jax_run, monkeypatch)
    loss, grads = trainer.g_loss_and_grads(torch.from_numpy(jax_run["zs"][0, 0]))
    theirs = jax_to_state_dict(trainer.g, jax_run["grads"], jax_run["init"][1])
    names = [n for n, _ in trainer.g.named_parameters()]
    assert len(names) == len(grads)
    for name, ours in zip(names, grads):
        ref = theirs[name].numpy()
        if name.startswith(("lcl_noise", "glb_noise")):  # neutralised: zero on both sides
            assert not ref.any() and not ours.any(), name
            continue
        # a tensor whose gradient is 0 on the JAX side (an SE gate whose
        # ReLU is shut for the whole batch) must be 0 here too
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(), err_msg=name)


def test_three_steps_in_lockstep_with_jax(jax_run, monkeypatch):
    _check_three_steps(jax_run, monkeypatch)


def _check_three_steps(jax_run, monkeypatch):
    trainer = _port_trainer(jax_run, monkeypatch)
    for k in range(STEPS):
        out = trainer.update_step(jax_run["reals"][k], zs=jax_run["zs"][k])
        ours = (out["loss_g"].item(), out["loss_d"].item())
        np.testing.assert_allclose(ours, jax_run["losses"][k], atol=LOSS_TOL,
                                   err_msg=f"losses at step {k}")
        state = _port_state((trainer.g.state_dict(), trainer.d.state_dict()))
        assert state.keys() == jax_run["states"][k].keys()
        for name, ref in jax_run["states"][k].items():
            np.testing.assert_allclose(state[name].numpy(), ref.numpy(), atol=STATE_TOL,
                                       err_msg=f"{name} after step {k}")
    assert trainer.step == STEPS


def test_packed_first_step_generator_gradients_match_jax(jax_run_packed, monkeypatch):
    """The packed pair: first-step G gradients per tensor within 1e-4, with
    every generator block through the fused BN + GELU op."""
    with _fast_gelu(True):
        calls = _count_fused(monkeypatch)
        _check_first_step_gradients(jax_run_packed, monkeypatch)
    assert calls == [32, 16, 8, 8, 8]  # the packed widths, ngf * mults


def test_packed_three_steps_in_lockstep_with_jax(jax_run_packed, monkeypatch):
    """The packed pair: losses, running statistics and u after each of
    three steps, as for the tuple pair."""
    with _fast_gelu(True):
        calls = _count_fused(monkeypatch)
        _check_three_steps(jax_run_packed, monkeypatch)
    # per step: the G phase's forward and the D phase's, five blocks each
    assert len(calls) == STEPS * 2 * 5


def test_full_width_32px_generator_and_discriminator_bridge():
    """The flagship pair at full width: the bridge takes every JAX leaf of
    G's params and batch statistics and of D's params and u once, and
    fills every port entry (it raises otherwise)."""
    jg = jffc_gan.FFCGenerator.for_resolution(32, z_size=128)
    jd = jffc_gan.SNConvDiscriminator.for_resolution(32)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = lambda m, x: jax.eval_shape(lambda x: m.init(rngs, x, True), x)
    g_vars = seeded_variables(shapes(jg, jnp.zeros((2, 128))), seed=1)
    d_vars = seeded_variables(shapes(jd, jnp.zeros((2, 32, 32, 3))), seed=2)
    for model, variables in ((FFCGenerator.for_resolution(32), g_vars),
                             (SNConvDiscriminator.for_resolution(32), d_vars)):
        state = jax_to_state_dict(model, variables["params"], variables.get("batch_stats"),
                                  variables.get("spectral"))
        assert set(state) == set(model.state_dict())
        n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables))
        assert sum(t.numel() for t in state.values()) == n_jax
        model.load_state_dict(state)
