"""The class-conditional models against the JAX package (CPU, f32): the
generators here and the helpers that
``tests/test_torch_conditional_discriminators.py`` holds the
discriminators to.

Each model of ``models/conditional.py`` starts from seeded variables at
unit signal scale in the JAX model's shapes (``seeded_variables``, with the
conditional BN's gamma tables moved to 1 + N(0, 0.1)), carried into the
port by the bridge (label tables, gamma and beta tables, ConvT biases, the
conditional spectral BN's statistics), and runs the same inputs at narrow
widths (ngf 16, z 32, batch 4) in training and in eval mode: the output,
after a training forward the running statistics and ``u`` of every layer,
and for the discriminators the gradient of the outputs' sum in the input,
which feeds the generator's gradient through D. Noise is left out on both
sides (NoiseInjection patched out, input noise at stddev 0 or off).

Bar: 1e-4 of the largest value (rel-max), as
``tests/test_torch_ffc_discriminator.py``; running statistics and ``u``
1e-5 absolute. A (leaky) ReLU input within f32 rounding of 0 can take the
other slope on one side, which moves an input gradient discretely (one at
1.1e-9 did so in the 32px ``CondSNDiscriminator`` at data seed 0); the
data seeds here leave no input that close.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.conditional as jcond
import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
import fastfourierconvolution_tpu_torch.models.conditional as tcond
import fastfourierconvolution_tpu_torch.models.ffc_gan as tffc_gan
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

from test_torch_ffc import nchw, nhwc, seeded_variables
from test_torch_train_step import _NoNoise, _NoNoiseHolder, _no_noise

TOL = 1e-4
STATE_TOL = 1e-5
BATCH, Z, NGF, CLASSES = 4, 32, 16, 10
LABELS = np.array([3, 0, 7, 3])


def cond_variables(shapes, seed):
    """``seeded_variables`` with every conditional BN's gamma table at
    1 + N(0, 0.1), as a BN scale."""
    variables = seeded_variables(shapes, seed)
    rng = np.random.default_rng(seed + 7)

    def leaf(path, x):
        return (1 + rng.normal(0, 0.1, x.shape)).astype(np.float32) if path[-1].key == "gamma" else x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture
def no_noise(monkeypatch):
    """NoiseInjection patched out on both sides."""
    monkeypatch.setattr(jcond, "NoiseInjection", _NoNoise)
    monkeypatch.setattr(jffc_gan, "NoiseWeightHolder", _NoNoiseHolder)
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)


def _rel_check(ours, ref, what):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL * np.abs(ref).max(), err_msg=what)


def _check_state(model, variables, upd):
    after = jax_to_state_dict(model, variables["params"],
                              upd.get("batch_stats", variables.get("batch_stats")),
                              upd.get("spectral", variables.get("spectral")))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), atol=STATE_TOL,
                                   err_msg=name)


def _bridge(model, variables):
    model.load_state_dict(jax_to_state_dict(model, variables["params"],
                                            variables.get("batch_stats"),
                                            variables.get("spectral")))
    return model


def check_generator(jmodel, port, train, seed=0):
    """``jmodel`` (flax) and ``port`` (its twin) on the same latents and
    labels, the port given the JAX model's seeded variables."""
    z = np.random.default_rng(seed).normal(size=(BATCH, jmodel.z_size)).astype(np.float32)
    y = jnp.asarray(LABELS)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jmodel.init(rngs, z, True, y), jnp.asarray(z))
    variables = cond_variables(shapes, seed + 1)
    out, upd = jmodel.apply(variables, jnp.asarray(z), train, y, rngs={"noise": rngs["noise"]},
                            mutable=["batch_stats"])
    _bridge(port, variables).train(train)
    with torch.no_grad():
        ours = port(torch.from_numpy(z), torch.float32, torch.Generator(),
                    torch.from_numpy(LABELS))
    _rel_check(nhwc(ours), out, "images")
    assert np.asarray(out).std() > 0.01  # real images, not a flat 0
    _check_state(port, variables, upd)
    return variables, upd


def check_discriminator(jmodel, port, resolution, channels, train, seed=0, labels=LABELS):
    """The same for a discriminator on (B, R, R, C) images and ``labels``,
    with the gradient of the outputs' sum in the images."""
    x = np.random.default_rng(seed).uniform(
        -1, 1, size=(BATCH, resolution, resolution, channels)).astype(np.float32)
    y = jnp.asarray(labels)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda v: jmodel.init(rngs, v, True, y), jnp.asarray(x))
    variables = cond_variables(shapes, seed + 1)

    def out_sum(v):
        out, upd = jmodel.apply(variables, v, train, y, rngs={"noise": rngs["noise"]},
                                mutable=["batch_stats", "spectral"])
        return out.sum(), (out, upd)

    (_, (out, upd)), gx_ref = jax.value_and_grad(out_sum, has_aux=True)(jnp.asarray(x))
    _bridge(port, variables).train(train)
    xt = nchw(x).requires_grad_(True)
    ours = port(xt, torch.float32, torch.from_numpy(labels), torch.Generator())
    (gx,) = torch.autograd.grad(ours.sum(), xt)
    _rel_check(ours.detach().numpy(), out, "outputs")
    _rel_check(nhwc(gx), gx_ref, "input gradient")
    with torch.no_grad():
        _check_state(port, variables, upd)


NARROW = dict(z_size=Z, num_classes=CLASSES, ngf=NGF)
GENERATORS = {
    "cifar32": dict(preset="cifar32"),
    "stl48": dict(preset="stl48"),
    "tex128-packed": dict(preset="tex128", ngf=8, ratio_g=0.5),
    "library64": dict(preset="library64"),
    "cifar32-cond-spectral-bn": dict(preset="cifar32", cond_spectral_bn=True),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_ffc_cond_generator_matches_jax(case, train, no_noise):
    """Each preset's stem and ladder: cifar32 (ConvT stems, conditional
    BN), stl48 (dense stem, 6x6 start), tex128 in packed-branch mode at five
    blocks (no conditional BN), library64 (no block norm), and cifar32 with
    class-conditional FourierUnits."""
    cfg = dict(GENERATORS[case])
    preset = cfg.pop("preset")
    kw = {**NARROW, **cfg}
    jmodel = jcond.FFCCondGenerator.for_preset(preset, **kw, impl="dft")
    port = tcond.FFCCondGenerator.for_preset(preset, **kw)
    assert port.packed == (case == "tex128-packed")
    check_generator(jmodel, port, train)


def test_labels_change_the_generator_output():
    """One latent batch under two label batches gives other images, and
    the conditional BN's per-class tables take their gradient only at the
    labels used."""
    g = tcond.FFCCondGenerator.for_preset("cifar32", **NARROW).eval()
    z = torch.randn(BATCH, Z, generator=torch.Generator().manual_seed(0))
    a = g(z, torch.float32, None, torch.from_numpy(LABELS))
    b = g(z, torch.float32, None, torch.from_numpy((LABELS + 1) % CLASSES))
    assert (a - b).abs().max() > 0.1 * a.abs().max()
    a.sum().backward()
    rows = g.block0.bn_l.gamma.grad.abs().sum(dim=1)
    assert set(torch.nonzero(rows).flatten().tolist()) == set(LABELS.tolist())


def test_generator_training_updates_running_statistics_as_jax(no_noise):
    """Two training forwards in a row move every BN's statistics as the
    JAX model's two forwards do (momentum 0.9 on the biased batch
    variance)."""
    jmodel = jcond.FFCCondGenerator.for_preset("cifar32", **NARROW, impl="dft")
    port = tcond.FFCCondGenerator.for_preset("cifar32", **NARROW)
    variables, upd = check_generator(jmodel, port, train=True)
    z = np.random.default_rng(9).normal(size=(BATCH, Z)).astype(np.float32)
    y = jnp.asarray(LABELS)
    _, upd2 = jmodel.apply({**variables, **upd}, jnp.asarray(z), True, y,
                           rngs={"noise": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    with torch.no_grad():
        port(torch.from_numpy(z), torch.float32, torch.Generator(), torch.from_numpy(LABELS))
    _check_state(port, variables, upd2)
    moved = [n for n, v in port.state_dict().items() if "running_mean" in n
             and not torch.equal(v, jax_to_state_dict(port, variables["params"],
                                                      variables["batch_stats"])[n])]
    assert any("bn_l" in n for n in moved) and any("label_bn" in n for n in moved)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cond_dcgan_generator_matches_jax(train):
    """Label and noise ConvT stems, the log2 ladder: ngf 16 gives 16px."""
    jmodel = jcond.CondDCGANGenerator(nz=Z, nc=1, ngf=NGF, num_classes=CLASSES)
    port = tcond.CondDCGANGenerator(nz=Z, nc=1, ngf=NGF, num_classes=CLASSES)
    jmodel.z_size = Z  # check_generator's latent width
    check_generator(jmodel, port, train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ffc_cond_dcgan_discriminator_with_spectral_norm_matches_jax(train):
    """``use_sn``: the FFC blocks' and the head's conv branches
    spectral-normed without bias, ndf 32 (32px images): outputs, the input
    gradient and every ``u`` after the forward (advanced in training)."""
    jmodel = jcond.FFCCondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_sn=True,
                                             impl="dft")
    port = tcond.FFCCondDCGANDiscriminator(nc=1, ndf=32, num_classes=CLASSES, use_sn=True)
    assert sum(n.endswith(".u") for n in port.state_dict()) == 7  # 2 + 3 branches, head 2
    check_discriminator(jmodel, port, 32, 1, train)


def test_models_refuse_missing_labels_and_packed_conditional_bn():
    g = tcond.FFCCondGenerator.for_preset("cifar32", **NARROW).eval()
    with pytest.raises(ValueError, match="labels"):
        g(torch.zeros(BATCH, Z))
    assert not tcond.FFCCondGenerator.for_preset("cifar32", **NARROW, packed=True).packed
    from fastfourierconvolution_tpu_torch.nn.ffc import FFC_BN_ACT

    with pytest.raises(ValueError, match="packed mode"):
        FFC_BN_ACT(8, 8, 3, 0.5, 0.5, packed=True, num_classes=CLASSES, norm="batch")
