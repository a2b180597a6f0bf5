"""The DCGAN family (``models/dcgan.py``) against the JAX package (CPU, f32),
and the helpers that ``tests/test_torch_sngan_resnet.py`` and
``tests/test_torch_sagan.py`` hold their models to.

Model checks: each JAX model's variables are replaced by seeded numpy
values at unit signal scale (``seeded_variables``) and reach the port
through the bridge; the same seeded inputs run in training and in eval
mode at narrow widths (batch 4). The spectral-norm vectors ``u`` are
scaled to unit norm, as the layers keep them, and in eval mode the
BatchNorms' running statistics are first calibrated to the batch
statistics of a JAX training forward on the same inputs, as a trained
model's are: seeded ones (and an eval-mode sigma from a ``u`` of norm
about 0.4) leave the activations unnormalised, and through the five
residual blocks of the 128px SNGAN generator they reached 1.4e4 before the
tanh, where f32 rounding alone (1.3e-6 of that scale on both sides) moves
images by more than the bar. Held: the output (images 1e-4 absolute,
logits and probabilities 1e-5 of their largest, as
``tests/test_torch_presets.py``), and after the forward every running
statistic and ``u`` to 1e-5 absolute.

Training lockstep (:func:`check_pair_lockstep`): a pair trains two steps at
batch 4 from the JAX ``GANTrainer.init`` variables, carried into the port
by the bridge, on the same real batches and latents (``zs``), with the bars
of ``tests/test_torch_train_conditional.py``: losses 1e-3, state 1e-4
absolute; a bias that feeds BatchNorm alone has a gradient of 0 up to
rounding, so it is left out, and the running mean BatchNorm keeps of it is
held to the bar plus their largest gap; after the first step an element
may leave the bar only where the port's gradient was at most ``FLIP_GRAD``
of its tensor's largest (Adam steps it by about lr whatever its size, so
rounding decides its sign), by at most two learning rates; after the
second, every element stays within the bar plus two learning rates per
step. A free bias of the discriminator that reaches its logits as a
constant moves the G loss (not the wgan D loss): the G loss is held to the
bar plus the logit shift the two sides' free biases give. Here: bce on ``DCGANGenerator`` against ``DCGANDiscriminator`` at
64px (separate D passes, as the JAX CLI runs a BN discriminator).
"""

from __future__ import annotations

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.dcgan as jdcgan
import fastfourierconvolution_tpu_torch.models.dcgan as tdcgan
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import GANTrainer
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.train import losses as tlosses

from test_torch_ffc import nchw, nhwc, seeded_variables
from test_torch_train_options import GP_EPS, _port_state
from test_torch_train_step import LOSS_TOL, STATE_TOL as STEP_STATE_TOL, TOTAL_STEPS

IMAGE_TOL = 1e-4
LOGIT_TOL = 1e-5
STATE_TOL = 1e-5
BATCH = 4
FLIP_GRAD = 1e-2
RNGS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}


def bridge(model, variables):
    model.load_state_dict(jax_to_state_dict(model, variables["params"],
                                            variables.get("batch_stats"),
                                            variables.get("spectral")))
    return model


def rel_max(ours, ref):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def run_both(jmodel, port, jax_args, port_call, train, seed, variables_fn=seeded_variables,
             edit=None):
    """``jmodel`` on ``jax_args`` (then ``train``) from seeded variables
    (``edit`` may change them), and ``port_call(port)`` after bridging
    them into ``port``; checks every running statistic and ``u`` of the
    port against the JAX model's after the forward. Returns (JAX output,
    port output)."""
    args = tuple(jnp.asarray(a) for a in jax_args)
    shapes = jax.eval_shape(lambda *a: jmodel.init(RNGS, *a[:1], True, *a[1:]), *args)
    variables = variables_fn(shapes, seed)
    if "spectral" in variables:
        variables["spectral"] = jax.tree_util.tree_map(
            lambda u: u / np.linalg.norm(u), variables["spectral"])
    if edit is not None:
        variables = edit(variables)
    mutable = [c for c in ("batch_stats", "spectral") if c in variables]
    if not train and "batch_stats" in variables:
        # flax stores 0.9 * running + 0.1 * batch
        _, upd = jmodel.apply(variables, *args[:1], True, *args[1:], mutable=mutable)
        variables = {**variables, "batch_stats": jax.tree_util.tree_map(
            lambda new, old: np.asarray((new - 0.9 * old) / 0.1, np.float32),
            upd["batch_stats"], variables["batch_stats"])}
    out, upd = jmodel.apply(variables, *args[:1], train, *args[1:], mutable=mutable)
    bridge(port, variables).train(train)
    with torch.no_grad():
        ours = port_call(port)
    after = jax_to_state_dict(port, variables["params"],
                              upd.get("batch_stats", variables.get("batch_stats")),
                              upd.get("spectral", variables.get("spectral")))
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), atol=STATE_TOL,
                                   err_msg=name)
    return out, ours


def bridge_shapes(jmodel, port, x, *extra):
    """Loads zeros in the shapes of ``jmodel``'s variables on input ``x``
    (then ``train``, then ``extra``) into ``port`` through the bridge,
    which raises unless every JAX leaf fills one port tensor of its shape
    and every port tensor is filled."""
    shapes = jax.eval_shape(lambda a: jmodel.init(RNGS, a, True, *extra), jnp.asarray(x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port.load_state_dict(jax_to_state_dict(port, zeros["params"], zeros.get("batch_stats"),
                                           zeros.get("spectral")))


def latents(z_size, seed=0):
    return np.random.default_rng(seed).normal(size=(BATCH, z_size)).astype(np.float32)


def images(resolution, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(BATCH, resolution, resolution, channels)).astype(np.float32)


def check_generator(jg, port, z, train, seed=1, **kw):
    out, ours = run_both(jg, port, (z,), lambda m: m(torch.from_numpy(z), torch.float32,
                                                      torch.Generator()), train, seed, **kw)
    np.testing.assert_allclose(nhwc(ours), np.asarray(out), atol=IMAGE_TOL)
    assert np.asarray(out).std() > 0.01  # real images, not a flat value


def check_discriminator(jd, port, x, train, seed=1, **kw):
    out, ours = run_both(jd, port, (x,), lambda m: m(nchw(x), torch.float32), train, seed, **kw)
    assert ours.shape == (BATCH, 1)
    assert rel_max(ours.numpy(), out) <= LOGIT_TOL


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dcgan_generator_matches_jax(train):
    check_generator(jdcgan.DCGANGenerator(nz=16, ngf=8), tdcgan.DCGANGenerator(nz=16, ngf=8),
                    latents(16), train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("sn", [False, True], ids=["bn", "sn"])
def test_dcgan_discriminators_match_jax(sn, train):
    """``DCGANDiscriminator`` (BN from the second conv) and
    ``SNDCGANDiscriminator`` (biased SN convs) on 64px images."""
    jd, port = ((jdcgan.SNDCGANDiscriminator(ndf=8), tdcgan.SNDCGANDiscriminator(ndf=8)) if sn
                else (jdcgan.DCGANDiscriminator(ndf=8), tdcgan.DCGANDiscriminator(ndf=8)))
    check_discriminator(jd, port, images(64), train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_attn_conv_generator_matches_jax(train):
    """The dense stem, three ConvT blocks and self-attention over the 32x32
    map (N = 1024), at the seeded gamma and at gamma 1."""
    def gamma_one(variables):
        variables["params"]["attn"]["gamma"] = np.float32(1.0)
        return variables

    for edit in (None, gamma_one):
        check_generator(jdcgan.AttnConvGenerator(z_size=16, mg=4, ngf=8),
                        tdcgan.AttnConvGenerator(z_size=16, mg=4, ngf=8), latents(16), train,
                        edit=edit)


# --- training lockstep --------------------------------------------------------------


def _flip_decided(trainer):
    """{parameter name: elements whose last gradient is at most FLIP_GRAD of
    its tensor's largest}."""
    return {f"{side}.{n}": p.grad.abs() <= FLIP_GRAD * p.grad.abs().max()
            for side, m in (("g", trainer.g), ("d", trainer.d)) for n, p in m.named_parameters()}


def _free_logit_offset(d, ref_state, free, real):
    """max |D(x) - D'(x)| over a batch, D' being D with its free biases
    (``free``) taken from ``ref_state``: the shift of the logits (a
    constant, as the biases it comes from add constants) that the two
    sides' free biases give, which the wgan D loss cancels but the G loss
    does not. Both are training forwards of copies; D is left as it is."""
    ours, theirs = copy.deepcopy(d), copy.deepcopy(d)
    with torch.no_grad():
        for name, p in theirs.named_parameters():
            if free.fullmatch(f"d.{name}"):
                p.copy_(ref_state[f"d.{name}"])
        x = nchw(real)
        return (ours(x) - theirs(x)).abs().max().item()


def check_pair_lockstep(jg, jd, port_g, port_d, options, resolution, z_size, monkeypatch,
                        free=r"(?!)", fed_mean=r"(?!)", edit=None, steps=2):
    """Two steps of the port's trainer with ``options`` against the JAX
    trainer's (jitted) on the same seeded reals and latents; ``free``
    matches the port's BN-fed biases, ``fed_mean`` the running means they
    feed; ``edit`` changes the JAX initial parameters before both sides
    start. wgan-gp's interpolation weights are ``GP_EPS`` on both sides."""
    n_dis = options.get("num_dis_updates", 1)
    rng = np.random.default_rng(0)
    reals = rng.uniform(-1, 1, size=(steps, BATCH, resolution, resolution, 3)).astype(np.float32)
    zs = rng.normal(size=(steps, 1 + n_dis, BATCH, z_size)).astype(np.float32)
    lr = max(options.get("lr", 2e-4), options.get("d_lr") or 0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        trainer = JGANTrainer(jg, jd, z_size=z_size, total_steps=TOTAL_STEPS, **options)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        if edit is not None:
            state = state.replace(g=state.g.replace(params=edit(state.g.params)),
                                  d=state.d.replace(params=edit(state.d.params)))
        init = jax.device_get((state.g, state.d))
        # the penalty's only uniform draw; patched after init, whose
        # initialisers draw uniforms too
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(GP_EPS))
        step = jax.jit(trainer.update_step)
        losses, states = [], []
        for k in range(steps):
            state, metrics = step(state, jnp.asarray(reals[k]), zs=jnp.asarray(zs[k]))
            losses.append((float(metrics["loss_g"]), float(metrics["loss_d"])))
            g, d = jax.device_get((state.g, state.d))
            states.append(_port_state(
                jax_to_state_dict(port_g, g.params, g.batch_stats, g.spectral),
                jax_to_state_dict(port_d, d.params, d.batch_stats, d.spectral)))

    monkeypatch.setattr(tlosses, "interpolation_weights",
                        lambda real, generator: torch.from_numpy(GP_EPS))
    g_init, d_init = init
    port_g.load_state_dict(jax_to_state_dict(port_g, g_init.params, g_init.batch_stats,
                                             g_init.spectral))
    port_d.load_state_dict(jax_to_state_dict(port_d, d_init.params, d_init.batch_stats,
                                             d_init.spectral))
    ours = GANTrainer(port_g, port_d, z_size=z_size, total_steps=TOTAL_STEPS, device="cpu",
                      dtype="f32", **options)
    free, fed_mean = re.compile(free), re.compile(fed_mean)
    params = _port_state(dict(ours.g.named_parameters()), dict(ours.d.named_parameters()))
    for k in range(steps):
        out = ours.update_step(reals[k], zs=zs[k])
        decided = _flip_decided(ours)
        state = _port_state(ours.g.state_dict(), ours.d.state_dict())
        assert state.keys() == states[k].keys()
        offset = _free_logit_offset(ours.d, states[k], free, reals[k])
        np.testing.assert_allclose(out["loss_d"].item(), losses[k][1], atol=LOSS_TOL,
                                   err_msg=f"loss_d at step {k}")
        np.testing.assert_allclose(out["loss_g"].item(), losses[k][0], atol=LOSS_TOL + offset,
                                   err_msg=f"loss_g at step {k} (free-bias offset {offset})")
        free_gap = max([(state[n] - ref).abs().max().item()
                        for n, ref in states[k].items() if free.fullmatch(n)], default=0.0)
        for key, ref in states[k].items():
            if free.fullmatch(key):
                continue
            gap = (state[key] - ref).abs()
            if key in params:
                off = gap > STEP_STATE_TOL
                assert k > 0 or not (off & ~decided[key]).any(), f"{key} after step {k}"
                assert gap.max().item() <= STEP_STATE_TOL + 2 * lr * (k + 1), (key, k, gap.max())
                continue
            tol = STEP_STATE_TOL + (free_gap if fed_mean.fullmatch(key) else 0.0)
            assert gap.max().item() <= tol, (f"{key} after step {k}", gap.max().item(), tol)
    assert ours.step == steps


def test_dcgan_pair_bce_in_lockstep_with_jax(monkeypatch):
    """bce, AdamW (the config's defaults), separate D passes, 64px, ngf =
    ndf 8, z 16."""
    check_pair_lockstep(jdcgan.DCGANGenerator(nz=16, ngf=8), jdcgan.DCGANDiscriminator(ndf=8),
                        tdcgan.DCGANGenerator(nz=16, ngf=8), tdcgan.DCGANDiscriminator(ndf=8),
                        dict(loss="bce"), 64, 16, monkeypatch=monkeypatch)
