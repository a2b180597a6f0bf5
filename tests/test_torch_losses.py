"""The port's GAN losses against the JAX package's on seeded inputs (CPU, f32).

BCE (probabilities clipped at 1e-7 from 0 and 1), Wasserstein, the gradient
penalty (the same interpolation weights on both sides) and the aw-method's
gradient combination in each of its three regimes. f32 on both sides, the
same arithmetic in another order: 1e-6 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.train import losses as jlosses
from fastfourierconvolution_tpu_torch.train import losses as tlosses

RTOL = 1e-6


def _logits(seed, shape=(8, 1), scale=2.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_bce_and_wgan_losses_match_jax(shift):
    """Probabilities in [0, 1], 0 and 1 included (the clip decides there),
    and raw logits for the Wasserstein pair."""
    rng = np.random.default_rng(1)
    fake = np.clip(rng.uniform(-0.2, 1.2, size=(8, 1)) + shift, 0, 1).astype(np.float32)
    real = np.clip(rng.uniform(-0.2, 1.2, size=(8, 1)), 0, 1).astype(np.float32)
    fake[0], real[1] = 0.0, 1.0
    pairs = [
        (jlosses.bce_loss_dis(jnp.asarray(fake), jnp.asarray(real)),
         tlosses.bce_loss_dis(torch.from_numpy(fake), torch.from_numpy(real))),
        (jlosses.bce_loss_gen(jnp.asarray(fake)), tlosses.bce_loss_gen(torch.from_numpy(fake))),
        (jlosses.bce_loss(jnp.asarray(real), 0.0), tlosses.bce_loss(torch.from_numpy(real), 0.0)),
    ]
    lf, lr = _logits(2, shift=shift), _logits(3)
    pairs += [
        (jlosses.wgan_loss_dis(jnp.asarray(lf), jnp.asarray(lr)),
         tlosses.wgan_loss_dis(torch.from_numpy(lf), torch.from_numpy(lr))),
        (jlosses.wgan_loss_gen(jnp.asarray(lf)), tlosses.wgan_loss_gen(torch.from_numpy(lf))),
    ]
    for ref, ours in pairs:
        np.testing.assert_allclose(ours.item(), float(ref), rtol=RTOL, atol=1e-7)


def test_gradient_penalty_matches_jax(monkeypatch):
    """A small two-layer critic (tanh, so the input gradient depends on
    the input) with the same weights on both sides; eps shared; the
    penalty and its gradient in the critic's weights."""
    rng = np.random.default_rng(4)
    w1 = (rng.normal(size=(4 * 4 * 3, 6)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(6, 1)) * 0.5).astype(np.float32)
    real = rng.normal(size=(5, 4, 4, 3)).astype(np.float32)
    fake = rng.normal(size=(5, 4, 4, 3)).astype(np.float32)
    eps = rng.uniform(size=(5, 1, 1, 1)).astype(np.float32)

    def jax_gp(w1, w2):
        def d_apply(x):
            return jnp.tanh(x.reshape(x.shape[0], -1) @ w1) @ w2
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(eps))
            return jlosses.gradient_penalty(d_apply, jnp.asarray(real), jnp.asarray(fake),
                                            jax.random.PRNGKey(0))

    ref, (ref_g1, ref_g2) = jax.value_and_grad(jax_gp, argnums=(0, 1))(
        jnp.asarray(w1), jnp.asarray(w2))
    monkeypatch.setattr(tlosses, "interpolation_weights",
                        lambda x, generator: torch.from_numpy(eps))
    t1, t2 = (torch.from_numpy(w).requires_grad_(True) for w in (w1, w2))
    d_of_x = lambda x: torch.tanh(x.reshape(x.shape[0], -1) @ t1) @ t2
    gp = tlosses.gradient_penalty(d_of_x, torch.from_numpy(real), torch.from_numpy(fake),
                                  torch.Generator())
    g1, g2 = torch.autograd.grad(gp, (t1, t2))
    np.testing.assert_allclose(gp.item(), float(ref), rtol=RTOL)
    for ours, theirs in ((g1, ref_g1), (g2, ref_g2)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(theirs)).max())


def test_interpolation_weights_come_from_the_generator():
    """eps is (B, 1, 1, 1) in [0, 1) and follows the generator's seed, not
    the global one."""
    real = torch.zeros(6, 3, 4, 4)
    a = tlosses.interpolation_weights(real, torch.Generator().manual_seed(5))
    torch.manual_seed(123)
    b = tlosses.interpolation_weights(real, torch.Generator().manual_seed(5))
    assert a.shape == (6, 1, 1, 1) and a.dtype == torch.float32
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


# (real logits shift, fake logits shift, whether g_fake = -g_real): the
# regime that aw_combine's scores select, and the sign of r·f.
AW_CASES = {
    "real-losing": (-3.0, 0.0, False),
    "real-losing-opposed": (-3.0, 0.0, True),
    "real-winning": (3.0, -3.0, False),
    "real-winning-opposed": (3.0, -3.0, True),
    "middle": (0.8, 0.0, False),
}


@pytest.mark.parametrize("case", list(AW_CASES))
def test_aw_combine_matches_jax_in_each_regime(case):
    """Two gradient 'trees' of three tensors; the logits place the mean
    sigmoid scores in the regime ``case`` names (checked), and the
    gradients are aligned or opposed (r·f > 0 or <= 0)."""
    real_shift, fake_shift, opposed = AW_CASES[case]
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    g_real = [rng.normal(size=s).astype(np.float32) for s in shapes]
    g_fake = [(-1.0 if opposed else 1.0) * g + 0.3 * rng.normal(size=g.shape).astype(np.float32)
              for g in g_real]
    real_logits = _logits(7, scale=0.3, shift=real_shift)
    fake_logits = _logits(8, scale=0.3, shift=fake_shift)
    rs = 1 / (1 + np.exp(-real_logits.astype(np.float64))).mean()
    fs = 1 / (1 + np.exp(-fake_logits.astype(np.float64))).mean()
    losing = rs < 0.5 or rs < fs - 0.05
    winning = rs > 0.75 and rs > fs - 0.05
    assert {"real-losing": losing, "real-winning": winning, "middle": not (losing or winning)}[
        case.replace("-opposed", "")]

    ref, ref_wr, ref_wf = jlosses.aw_combine(
        {str(i): jnp.asarray(g) for i, g in enumerate(g_real)},
        {str(i): jnp.asarray(g) for i, g in enumerate(g_fake)},
        jnp.asarray(real_logits), jnp.asarray(fake_logits))
    ours, w_r, w_f = tlosses.aw_combine(
        [torch.from_numpy(g) for g in g_real], [torch.from_numpy(g) for g in g_fake],
        torch.from_numpy(real_logits), torch.from_numpy(fake_logits))
    np.testing.assert_allclose((w_r.item(), w_f.item()), (float(ref_wr), float(ref_wf)),
                               rtol=1e-5)
    for i, t in enumerate(ours):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[str(i)]), rtol=1e-5, atol=1e-7)


def test_aw_combine_rejects_alphas_out_of_order():
    g = [torch.ones(3)]
    logits = torch.zeros(2, 1)
    for a1, a2 in ((0.75, 0.5), (0.6, 0.6)):
        with pytest.raises(ValueError, match="alpha1"):
            tlosses.aw_combine(g, g, logits, logits, alpha1=a1, alpha2=a2)
