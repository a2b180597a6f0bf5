"""The port's FourierUnit training op against the JAX package (CPU, f32).

The train forward's plain version is held against ``_spec_forward`` and the
interpret-mode Pallas stats kernels it replaces; the plain backward against
the JAX custom VJP, the interpret-mode Pallas backward kernels, and torch's
own autograd through the plain forward. Inputs come from numpy with a seed,
NHWC to JAX and NCHW to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.ops.pallas import fourier_unit as jfu
from fastfourierconvolution_tpu_torch.ops import fourier_unit as tfu

from test_torch_fourier_unit import _fu_inputs

SHAPES = [(4, 8, 8, 6), (2, 16, 16, 8)]  # (B, H, W, C)
# The interpret-mode Pallas kernels are slow on the CPU: one small shape.
PALLAS_SHAPE = (3, 8, 8, 6)
KERNEL_WRAPPERS = (
    tfu.fourier_unit_forward, tfu.fu_train_stats, tfu.fu_bwd_stats,
    tfu.fu_bwd_apply, tfu.fu_reduce,
)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _train_inputs(shape, seed):
    """x (NHWC), kernel, scale, bias and a cotangent gy, numpy f32."""
    x, kernel, scale, bias, _, _ = _fu_inputs(shape, seed)
    gy = np.random.default_rng(seed + 100).normal(size=x.shape).astype(np.float32)
    return x, kernel, scale, bias, gy


def _port(x, kernel, scale, bias, gy=None):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    out = (nchw(x), *(torch.from_numpy(a) for a in (kernel, scale, bias)))
    return out if gy is None else out + (nchw(gy),)


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_stats_args(x, kernel, scale, bias):
    c2 = kernel.shape[0]
    return tuple(jnp.asarray(a) for a in (x, kernel, scale, bias)) + (
        jnp.zeros(c2), jnp.ones(c2),
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_train_plain_matches_jax_spec_forward(shape):
    """Same math in f32: y to 1e-5 absolute on O(1) outputs, the batch
    statistics to 1e-5 (sums over B*H*Wf elements in another order)."""
    x, kernel, scale, bias, _ = _train_inputs(shape, seed=0)
    y_j, m_j, v_j = jfu._spec_forward(*_jax_stats_args(x, kernel, scale, bias), True)
    y_t, m_t, v_t = tfu.fourier_unit_train_plain(*_port(x, kernel, scale, bias))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("mode", ["sep", "kron"])
def test_train_plain_matches_jax_pallas_stats_interpret(mode):
    """Against the Pallas train forward (stats kernel, rows 4-6 of the
    kernel table, then the apply kernel), interpret mode: 2e-5 absolute,
    the bar the JAX package holds those kernels to against _spec_forward."""
    x, kernel, scale, bias, _ = _train_inputs(PALLAS_SHAPE, seed=1)
    y_p, m_p, v_p = jfu._pallas_forward(
        *_jax_stats_args(x, kernel, scale, bias), True, interpret=True, mode=mode
    )
    y_t, m_t, v_t = tfu.fourier_unit_train_plain(*_port(x, kernel, scale, bias))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_p), atol=2e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_p), atol=2e-5)
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_p), atol=2e-5)


def _port_backward(x, kernel, scale, bias, gy, train):
    xt, kt, st, bt, gyt = _port(x, kernel, scale, bias, gy)
    if train:
        bmean, bvar = tfu.fu_train_stats_plain(xt, kt)
    else:
        c2 = kernel.shape[0]
        bmean = torch.from_numpy(np.linspace(-0.1, 0.1, c2, dtype=np.float32))
        bvar = torch.from_numpy(np.linspace(0.5, 1.5, c2, dtype=np.float32))
    grads = tfu.fourier_unit_backward_plain(xt, kt, st, bt, bmean, bvar, gyt, train)
    return (bmean, bvar), (_nhwc(grads[0]), *(g.numpy() for g in grads[1:]))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_jax_custom_vjp(shape, train):
    """jax.vjp of fourier_unit_fused (whose VJP is _jnp_backward on the
    CPU): every gradient to 1e-4 rel-max, the bar the JAX package holds
    its own backward kernels to; zero gradients for the statistics."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=2)
    (bmean, bvar), ours = _port_backward(x, kernel, scale, bias, gy, train)
    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias)) + (
        jnp.asarray(bmean.numpy()), jnp.asarray(bvar.numpy()),
    )
    (_, m_j, v_j), vjp = jax.vjp(lambda *a: jfu.fourier_unit_fused(*a, train), *args)
    theirs = vjp((jnp.asarray(gy), jnp.zeros_like(m_j), jnp.zeros_like(v_j)))
    for name, a, b in zip(("gx", "gK", "gscale", "gbias"), ours, theirs):
        assert _rel_max(a, b) <= 1e-4, (name, _rel_max(a, b))
    assert not ours[4].any() and not ours[5].any()


@pytest.mark.parametrize("mode", ["sep", "kron"])
def test_backward_plain_matches_jax_pallas_backward_interpret(mode):
    """Against the Pallas backward (stats kernel, rows 7-9, and apply
    kernel, rows 10-12), interpret mode, train: 1e-4 rel-max."""
    x, kernel, scale, bias, gy = _train_inputs(PALLAS_SHAPE, seed=3)
    (bmean, bvar), ours = _port_backward(x, kernel, scale, bias, gy, True)
    theirs = jfu._pallas_backward(
        *(jnp.asarray(a) for a in (x, kernel, scale, bias)),
        jnp.asarray(bmean.numpy()), jnp.asarray(bvar.numpy()), jnp.asarray(gy),
        True, interpret=True, mode=mode,
    )
    for name, a, b in zip(("gx", "gK", "gscale", "gbias"), ours, theirs):
        assert _rel_max(a, b) <= 1e-4, (name, _rel_max(a, b))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_torch_autograd(shape):
    """The hand-written adjoint against torch differentiating the plain
    train forward (batch statistics inside the graph): 1e-5 rel-max, f32
    rounding of two orders of the same sums."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=4)
    leaves = [t.requires_grad_() for t in _port(x, kernel, scale, bias)]
    gyt = _port(x, kernel, scale, bias, gy)[-1]
    y, bmean, bvar = tfu.fourier_unit_train_plain(*leaves)
    auto = torch.autograd.grad((y * gyt).sum(), leaves)
    ours = tfu.fourier_unit_backward_plain(
        *(t.detach() for t in leaves), bmean.detach(), bvar.detach(), gyt
    )
    for name, a, b in zip(("gx", "gK", "gscale", "gbias"), ours, auto):
        assert _rel_max(a.numpy(), b.numpy()) <= 1e-5, name


def test_training_op_on_cpu_tensors_runs_the_plain_versions_without_launching():
    """The autograd Function on CPU tensors: the plain forward's values,
    the plain backward's gradients, non-differentiable statistics, and no
    kernel launch counted."""
    x, kernel, scale, bias, gy = _train_inputs((2, 16, 16, 8), seed=5)
    before = [(f.launches, sum(f.launches_by_map.values())) for f in KERNEL_WRAPPERS]
    leaves = [t.requires_grad_() for t in _port(x, kernel, scale, bias)]
    gyt = _port(x, kernel, scale, bias, gy)[-1]
    y, bmean, bvar = tfu.fourier_unit_train(*leaves)
    assert not bmean.requires_grad and not bvar.requires_grad
    y_p, m_p, v_p = tfu.fourier_unit_train_plain(*(t.detach() for t in leaves))
    assert torch.equal(y.detach(), y_p) and torch.equal(bmean, m_p) and torch.equal(bvar, v_p)
    grads = torch.autograd.grad((y * gyt).sum(), leaves)
    plain = tfu.fourier_unit_backward_plain(*(t.detach() for t in leaves), m_p, v_p, gyt)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    assert [(f.launches, sum(f.launches_by_map.values())) for f in KERNEL_WRAPPERS] == before


def test_reduce_plain_sums_and_moments():
    rng = np.random.default_rng(6)
    partial = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    torch.testing.assert_close(tfu.fu_reduce(partial), partial.sum(0))
    mean, var = tfu.fu_reduce(partial, count=20).split(4)
    torch.testing.assert_close(mean, partial[:, :4].sum(0) / 20)
    torch.testing.assert_close(var, partial[:, 4:].sum(0) / 20 - mean * mean)
    with pytest.raises(ValueError, match="even"):
        tfu.fu_reduce(partial[:, :5], count=20)


def test_training_op_rejects_malformed_operands():
    x, kernel, scale, bias, gy = _port(*_train_inputs((2, 8, 8, 4), seed=7))
    with pytest.raises(ValueError, match="bias"):
        tfu.fourier_unit_train(x, kernel, scale, bias[:3])
    with pytest.raises(ValueError, match="gy"):
        tfu.fu_bwd_stats(x, kernel, scale, bias, scale, scale, gy[:1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfu.fu_train_stats(x.double(), kernel.double())
