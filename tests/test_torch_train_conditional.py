"""The port's conditional training path in lockstep with the JAX package's
``GANTrainer`` (CPU, f32), and ``generate``.

Each pair trains two steps at batch 4 from the JAX ``GANTrainer.init``
variables, carried into the port by the bridge, on the same real batches,
labels and latents (``zs``), as ``tests/test_torch_train_options.py`` runs
its pairs:

- the ``fgan_cond32`` pair: ``FFCCondGenerator`` (cifar32 preset at ngf 16,
  z 32) against ``CondSNDiscriminator(32)``, fused D pass, hinge, AdamW;
  the discriminator's SN ladder is narrowed on both sides to
  ``LADDER`` (three convs, 16-32 features) by patching the ladder tables;
- a 16px two-block generator of the same kind against
  ``FFCCondDiscriminator`` at 16px (FourierUnits on (4, 16, 8, 8) and
  (4, 32, 4, 4); separate passes);
- the ``train_cond`` pair: ``CondDCGANGenerator`` and
  ``CondDCGANDiscriminator`` with input noise at ngf = ndf 16 on one
  channel, bce, Adam, D first, ``d_progress_arg``: the noise's N(0, 1)
  draw is patched to one array on both sides, so the progress (step /
  total_steps) sets the only difference between the steps' noise.

NoiseInjection is neutralised on both sides and FFCCondDiscriminator's
input noise runs at stddev 0. Bars as in
``tests/test_torch_train_options.py``: losses 1e-3, state 1e-4; a
convolution bias that feeds BatchNorm has a gradient of 0 up to rounding,
so it is left out, and the running mean that BatchNorm keeps of it is held
to the bar plus their largest gap. Adam steps an element by about lr
whatever the size of its gradient, so where the two sides' gradients may
differ by more than the element's own size, its step's sign is decided by
rounding. The jitted JAX step is the reference here, and its D gradients
are not f32-sharp: at the full-width ``fgan_cond32`` pair they sat 3.4e-3
rel-max (conv0) from the same step run op by op (XLA CPU, f32), which the
port's matched within 3.2e-6, and that flipped Adam's step in 222 of
conv3's 262,144 elements. So after the first step an element may leave
the state bar, by at most two learning rates, only where the port's
gradient was at most ``FLIP_GRAD`` of its tensor's largest, above that
3.4e-3; a wrong gradient moves elements of every size. After the second
step, whose D gradients move discretely where a LeakyReLU input that lies
within rounding of its kink takes the other slope on one side (at init
the discriminators' activations are small: 21 of the narrowed
``fgan_cond32`` D's inputs lay within 1e-6 of it, in f64), every parameter
element stays within the bar plus two learning rates per step, and the
losses, running statistics and ``u`` hold their bars.

Also: ``update_steps(reals, labels)`` against K ``update_step`` calls (bit
for bit), ``generate(z, labels, uint8=True)`` against the JAX trainer's
(f32: at most 1 uint8 level), and the trainer's label checks.
"""

from __future__ import annotations

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.conditional as jcond
import fastfourierconvolution_tpu_torch.models.conditional as tcond
import fastfourierconvolution_tpu_torch.models.ffc_gan as tffc_gan
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import GANTrainer
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

from test_torch_ffc import nchw
from test_torch_train_options import _port_state
from test_torch_train_step import (
    LADDER,
    LOSS_TOL,
    STATE_TOL,
    TOTAL_STEPS,
    _NoNoise,
    _no_noise,
)

BATCH, STEPS, Z, CLASSES = 4, 2, 32, 10
LABELS = np.array([[3, 0, 7, 3], [1, 9, 9, 4]])
NARROW_G = dict(z_size=Z, num_classes=CLASSES, ngf=16)
LR = 2e-4
FLIP_GRAD = 1e-2


G16 = dict(stem="convt", cond_bn=True, mg=4, channel_mults=(2, 1), **NARROW_G)


def _pairs(name):
    """(JAX G, JAX D, port G, port D, resolution, channels, trainer options,
    the port's free biases (regex))."""
    if name == "cond32":
        return (jcond.FFCCondGenerator.for_preset("cifar32", **NARROW_G, impl="dft"),
                jcond.CondSNDiscriminator(num_classes=CLASSES, resolution=32),
                tcond.FFCCondGenerator.for_preset("cifar32", **NARROW_G),
                tcond.CondSNDiscriminator(num_classes=CLASSES, resolution=32),
                32, 3, dict(fused_dis_batch=True), r"g\.(label|input)_conv\.bias")
    if name == "ffc-d":
        return (jcond.FFCCondGenerator(**G16, impl="dft"),
                jcond.FFCCondDiscriminator(num_classes=CLASSES, noise_stddev=0.0, impl="dft"),
                tcond.FFCCondGenerator(**G16),
                tcond.FFCCondDiscriminator(num_classes=CLASSES, noise_stddev=0.0, resolution=16),
                16, 3, dict(), r"g\.(label|input)_conv\.bias|d\.block[0-3]\.ffc\.conv(l2l|l2g|g2l)\.bias")
    dcgan = dict(nz=Z, nc=1, ngf=16, num_classes=CLASSES)
    d_kw = dict(nc=1, ndf=16, num_classes=CLASSES, use_noise=True)
    return (jcond.CondDCGANGenerator(**dcgan), jcond.CondDCGANDiscriminator(**d_kw),
            tcond.CondDCGANGenerator(**dcgan), tcond.CondDCGANDiscriminator(**d_kw),
            16, 1, dict(loss="bce", optimizer="adam", update_order="d_first",
                        d_progress_arg=True), r"g\.(label|input)_conv\.bias")


def _data(resolution, channels):
    rng = np.random.default_rng(0)
    reals = rng.uniform(-1, 1, size=(STEPS, BATCH, resolution, resolution, channels))
    zs = rng.normal(size=(STEPS, 2, BATCH, Z))
    noise = rng.normal(size=(BATCH, resolution, resolution, channels))
    return reals.astype(np.float32), zs.astype(np.float32), noise.astype(np.float32)


@pytest.fixture
def narrow_ladder(monkeypatch):
    """The 32px SN ladder narrowed to ``LADDER`` on both sides."""
    monkeypatch.setattr(jcond, "_D_LADDERS", {32: LADDER})
    monkeypatch.setattr(tcond, "D_LADDERS", {32: LADDER})


def _jax_run(name):
    jg, jd, port_g, port_d, res, channels, options, _ = _pairs(name)
    reals, zs, noise = _data(res, channels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcond, "NoiseInjection", _NoNoise)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        trainer = JGANTrainer(jg, jd, z_size=Z, total_steps=TOTAL_STEPS, conditional=True,
                              num_classes=CLASSES, **options)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        init = jax.device_get((state.g, state.d))
        # the D input noise's only normal draw (of the images' shape);
        # patched after init, whose initialisers draw normals too
        normal = jax.random.normal
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: (
            jnp.asarray(noise) if tuple(shape) == noise.shape else normal(key, shape, *a, **k)))
        step = jax.jit(trainer.update_step)
        losses, states = [], []
        for k in range(STEPS):
            state, metrics = step(state, jnp.asarray(reals[k]), jnp.asarray(LABELS[k]),
                                  zs=jnp.asarray(zs[k]))
            losses.append((float(metrics["loss_g"]), float(metrics["loss_d"])))
            g, d = jax.device_get((state.g, state.d))
            states.append(_port_state(
                jax_to_state_dict(port_g, g.params, g.batch_stats),
                jax_to_state_dict(port_d, d.params, d.batch_stats, d.spectral),
            ))
    return dict(init=init, losses=losses, states=states, reals=reals, zs=zs, noise=noise)


def _port_trainer(name, run, monkeypatch):
    _, _, g, d, _, _, options, _ = _pairs(name)
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)
    monkeypatch.setattr(tcond, "draw_input_noise", lambda x, gen: nchw(run["noise"]))
    g_init, d_init = run["init"]
    g.load_state_dict(jax_to_state_dict(g, g_init.params, g_init.batch_stats))
    d.load_state_dict(jax_to_state_dict(d, d_init.params, d_init.batch_stats, d_init.spectral))
    return GANTrainer(g, d, z_size=Z, total_steps=TOTAL_STEPS, conditional=True,
                      num_classes=CLASSES, device="cpu", dtype="f32", **options)


@pytest.mark.parametrize("name", ["cond32", "ffc-d", "train-cond"])
def test_conditional_pair_in_lockstep_with_jax(name, narrow_ladder, monkeypatch):
    """Two steps: the losses, then every parameter, running statistic and
    ``u`` of both models after each step."""
    run = _jax_run(name)
    trainer = _port_trainer(name, run, monkeypatch)
    free = re.compile(_pairs(name)[-1])
    fed_mean = re.compile(r"g\.(label|input)_bn\.running_mean|d\.block[0-3]\.bn_[lg]\.running_mean")
    params = {f"{side}.{n}": p for side, m in (("g", trainer.g), ("d", trainer.d))
              for n, p in m.named_parameters()}
    for k in range(STEPS):
        out = trainer.update_step(run["reals"][k], LABELS[k], zs=run["zs"][k])
        # .grad: the step's last update's gradient
        decided = {n: p.grad.abs() <= FLIP_GRAD * p.grad.abs().max() for n, p in params.items()}
        ours = (out["loss_g"].item(), out["loss_d"].item())
        np.testing.assert_allclose(ours, run["losses"][k], atol=LOSS_TOL,
                                   err_msg=f"losses at step {k}")
        state = _port_state(trainer.g.state_dict(), trainer.d.state_dict())
        assert state.keys() == run["states"][k].keys()
        free_gap = max([(state[n] - ref).abs().max().item()
                        for n, ref in run["states"][k].items() if free.fullmatch(n)],
                       default=0.0)
        for key, ref in run["states"][k].items():
            if free.fullmatch(key):
                continue
            if key in params:
                off = (state[key] - ref).abs() > STATE_TOL
                assert k > 0 or not (off & ~decided[key]).any(), f"{key} after step {k}"
                gap = (state[key] - ref).abs().max().item()
                assert gap <= STATE_TOL + 2 * LR * (k + 1), (key, k, gap)
                continue
            tol = STATE_TOL + (free_gap if fed_mean.fullmatch(key) else 0.0)
            np.testing.assert_allclose(state[key].numpy(), ref.numpy(), atol=tol,
                                       err_msg=f"{key} after step {k}")
    assert trainer.step == STEPS
    if name == "train-cond":
        assert trainer.step_count.item() == STEPS


def _small_trainer(**options):
    g = tcond.FFCCondGenerator(z_size=8, num_classes=3, ngf=8, mg=4, channel_mults=(2, 2, 1))
    d = tcond.CondSNDiscriminator(num_classes=3, resolution=32, use_noise=True)
    return GANTrainer(g, d, z_size=8, total_steps=20, conditional=True, num_classes=3,
                      device="cpu", **options)


def test_update_steps_with_labels_is_update_step_k_times():
    """From a deep copy of one conditional trainer (with D's input noise
    and ``d_progress_arg`` off): ``update_steps(reals, labels)`` and K
    ``update_step`` calls give the same losses, state and generator
    states, bit for bit."""
    trainer = _small_trainer(fused_dis_batch=True)
    gen = torch.Generator().manual_seed(0)
    reals = torch.rand(3, 2, 32, 32, 3, generator=gen) * 2 - 1
    labels = torch.randint(0, 3, (3, 2), generator=gen)
    trainer.update_step(reals[0], labels[0])
    twin = copy.deepcopy(trainer)
    out = trainer.update_steps(reals, labels)
    eager = [twin.update_step(r, y) for r, y in zip(reals, labels)]
    for key, losses in out.items():
        assert torch.equal(losses, torch.stack([e[key] for e in eager])), key
    for a, b in zip(list(trainer.g.state_dict().values()) + list(trainer.d.state_dict().values()),
                    list(twin.g.state_dict().values()) + list(twin.d.state_dict().values())):
        assert torch.equal(a, b)
    assert torch.equal(trainer.noise_generator.get_state(), twin.noise_generator.get_state())
    assert trainer.step == twin.step == 4


def test_generate_matches_jax(monkeypatch):
    """``generate(z, labels)`` against the JAX trainer's on the same seeded
    G variables: eval-mode G (running statistics, no noise), the floats to
    1e-4 of their largest, the uint8 images within one level; G's
    training flag is restored and no state moves."""
    from test_torch_conditional import cond_variables

    jg, jd, g, d, *_ = _pairs("cond32")
    jtrainer = JGANTrainer(jg, jd, z_size=Z, conditional=True, num_classes=CLASSES)
    z = np.random.default_rng(5).normal(size=(BATCH, Z)).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        state = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
        variables = cond_variables({"params": state.g.params,
                                    "batch_stats": state.g.batch_stats}, 3)
        state = state.replace(g=state.g.replace(**variables))
        ref = np.asarray(jtrainer.generate(state, jnp.asarray(z), jnp.asarray(LABELS[0])))
        ref_u8 = np.asarray(jtrainer.generate(state, jnp.asarray(z), jnp.asarray(LABELS[0]),
                                              uint8=True))
    g.load_state_dict(jax_to_state_dict(g, variables["params"], variables["batch_stats"]))
    trainer = GANTrainer(g, d, z_size=Z, conditional=True, num_classes=CLASSES, device="cpu")
    before = copy.deepcopy(trainer.g.state_dict())
    floats = trainer.generate(z, LABELS[0])
    images = trainer.generate(z, LABELS[0], uint8=True)
    assert trainer.g.training
    assert all(torch.equal(v, before[k]) for k, v in trainer.g.state_dict().items())
    assert images.dtype == torch.uint8 and tuple(images.shape) == ref_u8.shape == (BATCH, 32, 32, 3)
    assert ref.std() > 0.01  # real images, not a flat 0
    np.testing.assert_allclose(floats.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert np.abs(images.numpy().astype(int) - ref_u8.astype(int)).max() <= 1


def test_trainer_checks_the_labels():
    trainer = _small_trainer()
    real = torch.zeros(2, 32, 32, 3)
    with pytest.raises(ValueError, match="needs labels"):
        trainer.update_step(real)
    with pytest.raises(ValueError, match=r"labels must be \(2,\)"):
        trainer.update_step(real, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"labels must be \(1, 2\)"):
        trainer.update_steps(real[None], torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="needs labels"):
        trainer.generate(torch.zeros(2, 8))
    assert trainer.step == 0
    uncond = GANTrainer(tffc_gan.FFCGenerator(z_size=8, ngf=8, mg=2, channel_mults=(2, 1)),
                        tffc_gan.SNConvDiscriminator(ladder=((8, 3, 1),), head_size=8),
                        z_size=8, device="cpu")
    with pytest.raises(ValueError, match="conditional trainer"):
        uncond.update_step(torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.int64))
    assert uncond.generate(torch.zeros(2, 8)).shape == (2, 8, 8, 3)
