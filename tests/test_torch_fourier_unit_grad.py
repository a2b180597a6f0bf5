"""The FourierUnit op's double backward and its eval-mode gradient against
the JAX package (CPU, f32).

The JAX package's ``fourier_unit_fused`` is a custom VJP whose forward and
backward are plain jnp on the CPU, so ``jax.grad`` differentiates it twice.
The port's ops are autograd Functions whose first-order backward comes from
the kernels (their plain versions here) and whose second-order term is the
VJP of the plain backward. Held here:

- the gradient, in x, K, scale and bias, of a gradient norm
  ``Σ w·(∂L/∂x)²`` with ``L = Σ gy·y``, through the training op and
  through the eval op, against ``jax.grad`` of the same function;
- the eval op's first-order gradients against ``jax.vjp`` of the eval
  forward;
- a 2-step f32 wgan-gp step of the JAX trainer with a narrow
  ``FFCDiscriminator``, whose penalty differentiates D's FourierUnits
  twice, in lockstep with the port's trainer.

Bars: 1e-4 rel-max per tensor, the bar of ``tests/test_torch_fourier_unit_train.py``
for the first-order backward; the lockstep takes the bars of
``tests/test_torch_train_options.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.ops.pallas import fourier_unit as jfu
from fastfourierconvolution_tpu_torch.ops import fourier_unit as tfu

from test_torch_fourier_unit_train import _nhwc, _port, _rel_max, _train_inputs
from test_torch_train_options import check_lockstep

SHAPES = [(4, 8, 8, 6), (2, 16, 16, 8)]  # (B, H, W, C)
TOL = 1e-4


def _eval_stats(c2):
    return (np.linspace(-0.1, 0.1, c2, dtype=np.float32),
            np.linspace(0.5, 1.5, c2, dtype=np.float32))


def _jax_penalty_grads(x, kernel, scale, bias, gy, w, train):
    """jax.grad, in (x, K, scale, bias), of Σ w·(∂(Σ gy·y)/∂x)²."""
    mean, var = (jnp.asarray(a) for a in _eval_stats(kernel.shape[0]))

    def inner(xx, k, s, b):
        y = jfu.fourier_unit_fused(xx, k, s, b, mean, var, train)[0]
        return jnp.sum(jnp.asarray(gy) * y)

    def penalty(*args):
        gx = jax.grad(inner)(*args)
        return jnp.sum(jnp.asarray(w) * gx * gx)

    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias))
    return jax.grad(penalty, argnums=(0, 1, 2, 3))(*args)


def _port_op(train, mean, var):
    if train:
        return lambda x, k, s, b: tfu.fourier_unit_train(x, k, s, b)[0]
    return lambda x, k, s, b: tfu.fourier_unit_eval(x, k, s, b, mean, var)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", SHAPES)
def test_double_backward_matches_jax(shape, train):
    """The gradient of a gradient norm through the op, every tensor within
    1e-4 rel-max of JAX's: in training the batch statistics' dependence on
    x and K is part of the second-order term, as JAX differentiates its
    forward's residuals."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=3)
    w = np.random.default_rng(4).uniform(0.5, 1.5, size=x.shape).astype(np.float32)
    theirs = _jax_penalty_grads(x, kernel, scale, bias, gy, w, train)
    leaves = [t.requires_grad_() for t in _port(x, kernel, scale, bias)]
    gyt, wt = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in (gy, w))
    mean, var = (torch.from_numpy(a) for a in _eval_stats(kernel.shape[0]))
    y = _port_op(train, mean, var)(*leaves)
    (gx,) = torch.autograd.grad((gyt * y).sum(), leaves[0], create_graph=True)
    ours = torch.autograd.grad((wt * gx * gx).sum(), leaves, materialize_grads=True)
    for name, a, b in zip(("x", "K", "scale", "bias"), ours, theirs):
        a = _nhwc(a) if name == "x" else a.numpy()
        assert _rel_max(a, b) <= TOL, (name, _rel_max(a, b))


def test_double_backward_leaves_out_the_statistics_only_in_eval():
    """The training op's second-order term differs from the one taken with
    the statistics held fixed: the recomputation matters."""
    x, kernel, scale, bias, gy = _train_inputs(SHAPES[0], seed=5)
    w = np.ones(x.shape, np.float32)
    leaves = [t.requires_grad_() for t in _port(x, kernel, scale, bias)]
    gyt = torch.from_numpy(gy).permute(0, 3, 1, 2).contiguous()
    y, bmean, bvar = tfu.fourier_unit_train(*leaves)
    (gx,) = torch.autograd.grad((gyt * y).sum(), leaves[0], create_graph=True)
    full = torch.autograd.grad((gx * gx).sum(), leaves[1])[0]
    held = _port_op(False, bmean.detach(), bvar.detach())(*leaves)
    (gx_held,) = torch.autograd.grad((gyt * held).sum(), leaves[0], create_graph=True)
    fixed = torch.autograd.grad((gx_held * gx_held).sum(), leaves[1])[0]
    theirs = _jax_penalty_grads(x, kernel, scale, bias, gy, w, True)[1]
    assert _rel_max(full.numpy(), theirs) <= TOL
    assert _rel_max(fixed.numpy(), theirs) > 100 * TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_eval_op_gradients_match_jax(shape):
    """jax.vjp of the eval forward: gx, gK, gscale and gbias within 1e-4
    rel-max; the running statistics get none."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=6)
    mean, var = _eval_stats(kernel.shape[0])
    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias, mean, var))
    _, vjp = jax.vjp(lambda *a: jfu.fourier_unit_fused(*a, False)[0], *args)
    theirs = vjp(jnp.asarray(gy))
    leaves = [t.requires_grad_() for t in _port(x, kernel, scale, bias)]
    stats = [torch.from_numpy(a).requires_grad_() for a in (mean, var)]
    y = tfu.fourier_unit_eval(*leaves, *stats)
    gyt = torch.from_numpy(gy).permute(0, 3, 1, 2).contiguous()
    ours = torch.autograd.grad(y, leaves + stats, gyt, allow_unused=True)
    for name, a, b in zip(("gx", "gK", "gscale", "gbias"), ours, theirs):
        a = _nhwc(a) if name == "gx" else a.numpy()
        assert _rel_max(a, b) <= TOL, (name, _rel_max(a, b))
    assert ours[4] is None or not ours[4].any()
    assert ours[5] is None or not ours[5].any()


def test_eval_module_forward_is_the_eval_op_on_the_cpu():
    """An eval-mode FourierUnit gives the plain forward's bits, and its
    input gradient the plain backward's."""
    from fastfourierconvolution_tpu_torch.nn.ffc import FourierUnit

    fu = FourierUnit(4)
    fu.reset_parameters(torch.Generator().manual_seed(0))
    fu.eval()
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
    y = fu(x)
    args = (fu.mix_kernel, fu.bn_scale, fu.bn_bias, fu.running_mean, fu.running_var)
    assert torch.equal(y, tfu.fourier_unit_forward_plain(x, *args))
    gy = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, gy)
    ref = tfu.fourier_unit_backward_plain(x.detach(), *args, gy, train=False)[0]
    assert torch.equal(gx, ref)


def test_wgan_gp_with_an_ffc_discriminator_in_lockstep_with_jax(monkeypatch):
    """Two f32 wgan-gp steps of the narrow generator against
    ``FFCDiscriminator``, whose two FourierUnits the penalty differentiates
    twice, in lockstep with the JAX trainer (``check_lockstep``'s bars)."""
    check_lockstep(dict(loss="wgan-gp", optimizer="adam", fused_dis_batch=False),
                   monkeypatch, d_kind="ffc")
