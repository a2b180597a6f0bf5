"""``GANTrainer.update_steps`` on the CPU, the learning-rate schedules and
the trainer's refusals (CPU, f32; no JAX). wgan-gp with a discriminator
that holds a FourierUnit, which the trainer once refused, is held to the
JAX trainer by ``tests/test_torch_fourier_unit_grad.py``.

On the CPU ``update_steps`` is ``update_step`` K times: the same bits, the
state advanced by K. The card's graph path is held against eager steps by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import copy

import pytest
import torch

from fastfourierconvolution_tpu_torch import FFCGenerator, GANTrainer, SNConvDiscriminator

Z, K = 8, 3


def _trainer(**options):
    g = FFCGenerator(z_size=Z, ngf=8, mg=2, channel_mults=(2, 1))  # 8px
    d = SNConvDiscriminator(ladder=((8, 3, 1), (8, 4, 2)), head_size=4)
    return GANTrainer(g, d, z_size=Z, total_steps=20, device="cpu", **options)


def _reals(seed=0):
    return torch.rand(K, 2, 8, 8, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def _state(trainer):
    moments = [v for opt in (trainer.g_opt, trainer.d_opt) for s in opt.state.values()
               for v in s.values()]
    return (list(trainer.g.state_dict().values()) + list(trainer.d.state_dict().values())
            + moments + [trainer.g_lr.lr, trainer.d_lr.lr, trainer.g_lr.count, trainer.d_lr.count])


@pytest.mark.parametrize("options", [
    dict(),
    dict(loss="wgan-gp", update_order="d_first", num_dis_updates=2),
    dict(aw_method=True),
], ids=["default", "wgan-gp-d-first", "aw-method"])
def test_update_steps_on_the_cpu_is_update_step_k_times(options):
    """From a deep copy of one trainer: K calls of ``update_step`` and one of
    ``update_steps`` give the same losses, parameters, buffers, moments,
    learning rates and generator states, bit for bit."""
    trainer = _trainer(**options)
    trainer.update_step(_reals(1)[0])  # the moments exist before the copy
    twin = copy.deepcopy(trainer)
    reals = _reals()
    out = trainer.update_steps(reals)
    eager = [twin.update_step(r) for r in reals]
    assert set(out) == {"loss_g", "loss_d"}
    for key, losses in out.items():
        assert losses.shape == (K,) and losses.dtype == torch.float32
        assert torch.equal(losses, torch.stack([e[key] for e in eager])), key
    assert trainer.step == twin.step == 1 + K
    assert all(torch.equal(a, b) for a, b in zip(_state(trainer), _state(twin)))
    for gen in ("z_generator", "noise_generator"):
        assert torch.equal(getattr(trainer, gen).get_state(), getattr(twin, gen).get_state())


def test_learning_rates_decay_linearly_and_d_runs_num_dis_updates_times_longer():
    """lr(t) = lr·max(1 - t/total, 0) at update t: G's over total_steps, D's
    over total_steps·num_dis_updates; the tensor holds the last update's."""
    trainer = _trainer(num_dis_updates=2, lr=1e-3, d_lr=4e-3)
    trainer.g_lr.total = 4
    trainer.d_lr.total = 8
    reals = _reals()
    for step in range(1, 6):
        trainer.update_step(reals[0])
        t_g, t_d = step - 1, 2 * step - 1
        assert trainer.g_lr.count.item() == step and trainer.d_lr.count.item() == 2 * step
        assert trainer.g_lr.lr.item() == pytest.approx(1e-3 * max(1 - t_g / 4, 0), abs=1e-9)
        assert trainer.d_lr.lr.item() == pytest.approx(4e-3 * max(1 - t_d / 8, 0), abs=1e-9)
    assert trainer.g_opt.param_groups[0]["lr"] is trainer.g_lr.lr


@pytest.mark.parametrize("options,match", [
    (dict(loss="lsgan"), "unknown loss"),
    (dict(update_order="g_last"), "unknown update order"),
    (dict(optimizer="sgd"), "unknown optimizer"),
    (dict(num_dis_updates=0), "at least 1"),
    (dict(aw_method=True, fused_dis_batch=True), "separate real and fake"),
    (dict(aw_method=True, loss="wgan-gp"), "aw-method takes"),
    (dict(aw_method=True, aw_alpha1=0.8), "aw_alpha1"),
])
def test_trainer_rejects_invalid_options(options, match):
    with pytest.raises(ValueError, match=match):
        _trainer(**options)


@pytest.mark.parametrize("options,match", [
    (dict(remat="dots"), "remat"),
    (dict(remat="full"), "remat"),
])
def test_trainer_refuses_what_is_not_ported(options, match):
    with pytest.raises(NotImplementedError, match=match):
        _trainer(**options)


def test_step_inputs_are_checked():
    trainer = _trainer(num_dis_updates=2)
    reals = _reals()
    with pytest.raises(ValueError, match="zs must be"):
        trainer.update_step(reals[0], zs=torch.zeros(2, 2, Z))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        trainer.update_step(reals)
    with pytest.raises(ValueError, match=r"\(K, B, H, W, C\)"):
        trainer.update_steps(reals[0])
    assert trainer.step == 0
