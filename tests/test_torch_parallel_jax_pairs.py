"""Data parallelism in the port against the JAX package (CPU, gloo): the
packed pair and the wgan-gp pair, each from the JAX trainer's init with
NoiseInjection neutralised, take their steps as two processes of a gloo
group (``tests/torch_parallel_worker.py``) on the same real batches and
latents as the JAX package's single-device ``update_step``.

- The packed pair of ``tests/test_torch_train_step.py`` (64px, batch 4,
  every generator block through the fused packed BN + GELU op's plain
  versions with the noise fold under the tanh GELU, fused D pass): three
  steps, the losses, running statistics and ``u`` at that file's bars.
  Its two-process steps also equal one process's at the bars of
  ``test_torch_parallel.py``.
- The wgan-gp pair of ``test_torch_parallel.py`` (the multi-process
  test's generator, 8px, against ``FFCDiscriminator(mg=1)``; wgan-gp,
  Adam, separate real and fake D passes, the sngan preset's pairing; BN
  and FourierUnit statistics inside the penalty's double backward), from
  the JAX init, batch 8, the interpolation weights given on both sides,
  the D update first (``update_order="d_first"``): the first D update's
  loss within 1e-3 and its gradients (Adam's first moments over 1 - b1 on
  both sides) within 1e-4 of each tensor's largest (``GRAD_TOL``;
  FFCDiscriminator's free biases left out, see
  ``test_torch_train_options.FREE_BIAS``). Nothing after an Adam step is
  compared: from this init Adam turns the sign of every gradient within
  rounding of 0 into a step of lr (55 of the 73,728 elements of D's
  ``block1.ffc.convl2l.weight`` lie within 1e-4 of its largest), and what
  follows parts between one process of the port and the JAX trainer
  alike (with the G update first, the D loss of step 0 by 2.9e-3; at step
  1 by 0.097). The seeded pair's three two-process steps equal one
  process's in ``test_torch_parallel.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import FFCDiscriminator, FFCGenerator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

import torch_parallel_worker as W
from test_torch_parallel import check_steps, one_thread, step_runs  # noqa: F401
from test_torch_train_options import FREE_BIAS
from test_torch_train_step import GRAD_TOL, LOSS_TOL, STATE_TOL, TOTAL_STEPS, _NoNoise

# wgan-gp's interpolation weights, one per item of the global batch.
GP_EPS = np.linspace(0.1, 0.9, W.GLOBAL_BATCH, dtype=np.float32).reshape(-1, 1, 1, 1)


def jax_gp_init(tmp_path):
    """The wgan-gp pair's JAX run (the first step from its init: the
    losses and the gradients it took), and its initial state and first
    batch written for the workers."""
    res, seed = W.SEEDED["gp"]
    rng = np.random.default_rng(seed)
    reals = rng.uniform(-1, 1, size=(1, W.GLOBAL_BATCH, res, res, 3)).astype(np.float32)
    zs = rng.normal(size=(1, 2, W.GLOBAL_BATCH, W.GP_OPTIONS["z_size"])).astype(np.float32)
    port_g, port_d = FFCGenerator(**W.MULTIHOST_G), FFCDiscriminator(**W.GP_D)
    options = {"update_order": "d_first",
               **{k: v for k, v in W.GP_OPTIONS.items() if k != "z_size"}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        jg = jffc_gan.FFCGenerator(**W.MULTIHOST_G, impl="dft")
        jd = jffc_gan.FFCDiscriminator(**W.GP_D, impl="dft")
        trainer = JGANTrainer(jg, jd, z_size=W.GP_OPTIONS["z_size"], total_steps=TOTAL_STEPS,
                              **options)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        g0, d0 = jax.device_get((state.g, state.d))
        # the penalty's only uniform draw; patched after init, whose dense
        # initialisers draw uniforms too
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(GP_EPS))
        state, metrics = jax.jit(trainer.update_step)(state, jnp.asarray(reals[0]),
                                                      zs=jnp.asarray(zs[0]))
        g, d = jax.device_get((state.g, state.d))
    losses = [(float(metrics["loss_g"]), float(metrics["loss_d"]))]
    # the first step's gradients: optax.adam's first moments over 1 - b1
    b1, grads = 0.5, {}
    for side, model, net in (("g", port_g, g), ("d", port_d, d)):
        names = dict(model.named_parameters())
        moments = jax_to_state_dict(model, net.opt_state[0].mu, net.batch_stats, net.spectral)
        grads.update({f"{side}.{n}": t / (1 - b1) for n, t in moments.items() if n in names})
    init = {"g_cfg": W.MULTIHOST_G, "packed": False, "d_kind": "ffc", "d_cfg": W.GP_D,
            "options": {**W.GP_OPTIONS, "update_order": "d_first"},
            "g": jax_to_state_dict(port_g, g0.params, g0.batch_stats),
            "d": jax_to_state_dict(port_d, d0.params, d0.batch_stats, d0.spectral)}
    torch.save(init, tmp_path / "init-gp.pt")
    np.savez(tmp_path / "data-gp.npz", reals=reals, zs=zs, gp_eps=GP_EPS)
    run = dict(losses=losses, grads=grads)
    return run, {"inputs": str(tmp_path / "init-gp.pt"), "data": str(tmp_path / "data-gp.npz")}


def test_two_process_steps_equal_one_process(step_runs):
    check_steps(*step_runs("jax-packed")[:2])


def test_packed_two_process_steps_in_lockstep_with_jax(step_runs):
    _, outs, jax_run = step_runs("jax-packed")
    for k, (losses, states) in enumerate(zip(jax_run["losses"], jax_run["states"])):
        np.testing.assert_allclose(outs[0]["losses"][k], losses, atol=LOSS_TOL,
                                   err_msg=f"losses at step {k}")
        for name, ref in states.items():
            np.testing.assert_allclose(outs[0]["states"][k][name].numpy(), ref.numpy(),
                                       atol=STATE_TOL, err_msg=f"{name} after step {k}")


def test_gp_two_process_first_step_in_lockstep_with_jax(step_runs):
    _, outs, jax_run = step_runs("jax-gp")
    np.testing.assert_allclose(outs[0]["losses"][0][1], jax_run["losses"][0][1], atol=LOSS_TOL)
    for name, ref in jax_run["grads"].items():
        if name.startswith("d.") and not FREE_BIAS.fullmatch(name):
            gap = (outs[0]["first_moments"][name] - ref).abs().max()
            assert gap <= GRAD_TOL * ref.abs().max(), (name, gap)
