"""The port in bf16 against the JAX package in bf16 (CPU).

Both run a narrow 32px generator (ngf 16, z 32) and a three-conv SN
discriminator on bridged JAX variables, with activations in bf16 and
parameters, BatchNorm state and SN state in f32.

How each side rounds. The JAX side runs op by op (``jax.disable_jit``):
every jnp op rounds its result to bf16, which is the program as written.
Under jit XLA fuses and rounds elsewhere: the same JAX training step gave
loss_g -0.019463 jitted and -0.019684 op by op, its generator images
differed by 5.9e-3 (bf16 against f32: 4.4e-3). Two library functions
are one op in PyTorch and several in jnp: the tanh-form GELU and the
sigmoid. PyTorch rounds each once; jnp run op by op rounds after each of
its steps (its constants too), which moved 45% of the GELU's and 32% of
the sigmoid's outputs by a bf16 ulp. The port keeps PyTorch's single op
(eight more launches per GELU on the card otherwise), and the JAX side
here evaluates those two in f32 and rounds once (``_single_rounding``).
The bias of a dense layer is added to the rounded product on both sides,
as the JAX code writes it. What is left is the order of f32 sums inside
the convolutions and matrix products (oneDNN against XLA), which moves a
bf16 rounding now and then (99.98% of a conv's outputs equal).

NoiseInjection is neutralised on both sides, as in test_torch_train_step.
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
from fastfourierconvolution_tpu.ops.pallas import fourier_unit as jfu
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import FFCGenerator, GANTrainer, SNConvDiscriminator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.ops import fourier_unit as tfu

from test_torch_ffc import seeded_variables
from test_torch_generator import NARROW
from test_torch_train_step import HEAD, LADDER, TOTAL_STEPS, _data, _no_noise, _NoNoise

BF16 = jnp.bfloat16
# Losses of the step, absolute: the f32 lockstep's bar (BASELINE.md's
# training A/B). Measured 6e-5 (loss_g) and 2e-5 (loss_d); JAX's own jitted
# step sits 2.2e-4 from its op-by-op one.
LOSS_TOL = 1e-3
# The first AdamW step moves each weight by lr·g/(|g| + 1e-8), about
# lr·sign(g), plus the decay, the same f32 arithmetic on both sides. A
# weight whose gradient is near 0 can move the other way, or less, on one
# side. An update counts as moved where the two differ by more than 1e-3
# of the tensor's largest update; share of moved updates per tensor:
# measured at most 2.0% (the stem; none in the FourierUnit's tensors and
# D's head); JAX's jitted bf16 step against its op-by-op one moves up to
# 4.7% of them.
MOVED_TOL = 0.05
DELTA_TOL = 1e-3


@contextlib.contextmanager
def _single_rounding(mp):
    """bf16 activations, op by op, with the JAX package's GELU (tanh form in
    bf16) and flax's sigmoid in f32, rounded once to the input's dtype, as
    PyTorch's single ops do."""
    def gelu(x):
        y = jax.nn.gelu(x.astype(jnp.float32), approximate=jlayers.gelu_is_fast(x.dtype))
        return y.astype(x.dtype)

    def sigmoid(x):
        return jax.nn.sigmoid(x.astype(jnp.float32)).astype(x.dtype)

    with mp.context() as inner:
        inner.setitem(jlayers.ACTIVATIONS, "gelu", gelu)
        inner.setattr(fnn, "sigmoid", sigmoid)
        inner.setattr(jpolicy, "_COMPUTE_DTYPE", BF16)
        with jax.disable_jit():
            yield


def _ulps(ours, ref):
    """max|ours - ref| in bf16 ulps at ref's largest magnitude."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return np.abs(ours - ref).max() / ulp


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(_f32(a)).permute(0, 3, 1, 2).contiguous().bfloat16()


def _port_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def test_fourier_unit_bf16_cast_points_match_jax():
    """The FourierUnit op, forward with batch statistics and backward, on the
    same bf16 operands: y, bmean and gbias bit for bit; bvar and gscale
    within 1e-5 rel-max (the f32 sums taken in another order); gx and gK
    within 1 bf16 ulp at their largest magnitude (such a sum moves a bf16
    rounding of gm now and then: measured 0.25 and 0.13 ulp)."""
    rng = np.random.default_rng(0)
    b, c, h, w = 4, 8, 16, 16
    x, gy = (jnp.asarray(rng.normal(size=(b, h, w, c)), BF16) for _ in range(2))
    kernel = jnp.asarray(rng.normal(size=(2 * c, 2 * c)) * 0.3, BF16)
    scale = (1 + 0.1 * rng.normal(size=2 * c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=2 * c)).astype(np.float32)
    with jax.disable_jit():
        y, bmean, bvar = jfu._spec_forward(x, kernel, scale, bias, None, None, True)
        grads = jfu._jnp_backward(x, kernel, scale, bias, bmean, bvar, gy, True)[:4]
    k_t = torch.from_numpy(_f32(kernel)).bfloat16()
    s_t, b_t = torch.from_numpy(scale), torch.from_numpy(bias)
    y_t, m_t, v_t = tfu.fourier_unit_train_plain(_nchw(x), k_t, s_t, b_t)
    g_t = tfu.fourier_unit_backward_plain(_nchw(x), k_t, s_t, b_t, m_t, v_t, _nchw(gy))[:4]
    assert y_t.dtype == g_t[0].dtype == g_t[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(_port_nhwc(y_t), _f32(y))
    np.testing.assert_array_equal(m_t.numpy(), _f32(bmean))
    np.testing.assert_array_equal(g_t[3].numpy(), _f32(grads[3]))
    for ours, ref in ((v_t.numpy(), _f32(bvar)), (g_t[2].numpy(), _f32(grads[2]))):
        assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    assert _ulps(_port_nhwc(g_t[0]), _f32(grads[0])) <= 1
    assert _ulps(g_t[1].float().numpy(), _f32(grads[1])) <= 1


def test_bf16_generator_eval_forward_matches_jax():
    """The narrow generator's eval forward in bf16: at least 99% of the image
    values equal to JAX's and none more than 1 bf16 ulp away at the
    images' largest magnitude (measured 99.8% and 0.5 ulp)."""
    jg = jffc_gan.FFCGenerator(**NARROW, impl="dft")
    z = np.random.default_rng(10).normal(size=(4, NARROW["z_size"])).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    variables = seeded_variables(
        jax.eval_shape(lambda z: jg.init(rngs, z, True), jnp.asarray(z)), 11)
    with _single_rounding(pytest.MonkeyPatch()):
        theirs = _f32(jg.apply(variables, jnp.asarray(z), False))
    model = FFCGenerator(**NARROW)
    model.load_state_dict(jax_to_state_dict(model, variables["params"],
                                            variables["batch_stats"]))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(z), torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    ours = _port_nhwc(ours)
    assert ours.shape == theirs.shape == (4, 32, 32, 3) and theirs.std() > 0.05
    assert (ours == theirs).mean() >= 0.99
    assert _ulps(ours, theirs) <= 1


# The tensors whose first-step updates are compared: G's stem, a local
# conv, the FourierUnit's mix kernel and BN scale, the output conv; D's
# first conv and head.
UPDATED = ("noise_to_feature.weight", "block0.ffc.convl2l.weight", "to_rgb.ffc.convl2l.weight",
           "block1.ffc.convg2g.fu.mix_kernel", "block1.ffc.convg2g.fu.bn_scale",
           "d.conv0.weight", "d.fc.weight")


def _flat_state(g, d):
    return {**g, **{f"d.{k}": v for k, v in d.items()}}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX trainer's initial variables, and its losses and parameters
    after one bf16 step, op by op, in the port's layouts."""
    reals, zs = _data(NARROW, 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        jg = jffc_gan.FFCGenerator(**NARROW, impl="dft")
        jd = jffc_gan.SNConvDiscriminator(ladder=LADDER, mg=HEAD)
        trainer = JGANTrainer(jg, jd, z_size=NARROW["z_size"], total_steps=TOTAL_STEPS,
                              fused_dis_batch=True)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        init = jax.device_get((state.g.params, state.g.batch_stats, state.d.params,
                               state.d.spectral))
        with _single_rounding(mp):
            state, metrics = trainer.update_step(state, jnp.asarray(reals[0]),
                                                 zs=jnp.asarray(zs[0]))
        after = jax.device_get((state.g.params, state.d.params))
    g, d = _port_pair()
    before = _flat_state(jax_to_state_dict(g, init[0], init[1]),
                         jax_to_state_dict(d, init[2], spectral=init[3]))
    after = _flat_state(jax_to_state_dict(g, after[0], init[1]),
                        jax_to_state_dict(d, after[1], spectral=init[3]))
    return dict(init=init, reals=reals, zs=zs, before=before, after=after,
                losses=(float(metrics["loss_g"]), float(metrics["loss_d"])))


def _port_pair():
    return FFCGenerator(**NARROW), SNConvDiscriminator(ladder=LADDER, head_size=HEAD)


def test_bf16_training_step_matches_jax(jax_step, monkeypatch):
    """One bf16 step from the same variables on the same batch: both losses
    within 1e-3; in each of seven tensors at most 5% of the updates more
    than 1e-3 of the largest update away from JAX's."""
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)
    g_params, g_stats, d_params, d_u = jax_step["init"]
    g, d = _port_pair()
    g.load_state_dict(jax_to_state_dict(g, g_params, g_stats))
    d.load_state_dict(jax_to_state_dict(d, d_params, spectral=d_u))
    trainer = GANTrainer(g, d, z_size=NARROW["z_size"], total_steps=TOTAL_STEPS,
                         fused_dis_batch=True, device="cpu", dtype="bf16")
    out = trainer.update_step(jax_step["reals"][0], zs=jax_step["zs"][0])
    np.testing.assert_allclose((out["loss_g"].item(), out["loss_d"].item()),
                               jax_step["losses"], atol=LOSS_TOL)
    state = _flat_state(g.state_dict(), d.state_dict())
    for name in UPDATED:
        ours = (state[name] - jax_step["before"][name]).numpy()
        ref = (jax_step["after"][name] - jax_step["before"][name]).numpy()
        moved = np.abs(ours - ref) > DELTA_TOL * np.abs(ref).max()
        assert moved.mean() <= MOVED_TOL, (name, moved.mean())
