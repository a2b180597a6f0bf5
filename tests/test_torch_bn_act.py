"""The port's fused packed BN + tanh-GELU (+ noise) op against the JAX
package's (CPU).

The JAX op runs as its own tests run it (``tests/test_fused_bn_act.py``):
the Pallas kernels in interpret mode, at (8, 8, 8, 128) NHWC with cl = 48.
The port runs its plain versions, which its wrappers take for CPU tensors.
Inputs are seeded numpy arrays; the port gets them in NCHW.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.ops.pallas import bn_act as jbn
from fastfourierconvolution_tpu_torch.ops import bn_act as tbn

SHAPE, CL = (8, 8, 8, 128), 48
# f32: rel-max = max|port - JAX| / max|JAX| on every output and gradient;
# the same math summed in other orders.
F32_TOL = 1e-5
# bf16 outputs: within 2 bf16 ulps at the output's magnitude, 2 * 2^(e - 7)
# with e = floor(log2 max|JAX|). The JAX op evaluates the GELU one bf16
# operation at a time, the port in f32 with one rounding, so near zero the
# two differ by many ulps of the element itself but by less than one ulp
# of the output's scale.
BF16_ULPS = 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(seed):
    rng = np.random.default_rng(seed)
    c = SHAPE[-1]
    x = (rng.normal(size=SHAPE) * 1.5 + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.2).astype(np.float32)
    w = (rng.normal(size=c) * 0.3).astype(np.float32)
    n_l = rng.normal(size=SHAPE[:3] + (1,)).astype(np.float32)
    n_g = rng.normal(size=SHAPE[:3] + (1,)).astype(np.float32)
    return x, scale, bias, w, n_l, n_g


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _ops(noise: bool):
    """(JAX op, port op) over (x, scale, bias[, w, n_l, n_g])."""
    if noise:
        return (lambda *a: jbn.packed_bn_gelu_noise(*a, CL, True),
                lambda *a: tbn.packed_bn_gelu_noise(*a, CL))
    return lambda *a: jbn.packed_bn_gelu(*a, True), tbn.packed_bn_gelu


def _operands(noise, jdt, tdt, seed):
    """The same operands for both packages: maps in the working dtype,
    vectors in f32."""
    x, scale, bias, w, n_l, n_g = _data(seed)
    maps = [x] + ([n_l, n_g] if noise else [])
    vecs = [scale, bias] + ([w] if noise else [])
    jmaps = [jnp.asarray(m, jdt) for m in maps]
    # the port gets the values the JAX side holds, rounded to bf16 alike
    tmaps = [_nchw(np.asarray(m.astype(jnp.float32)), tdt) for m in jmaps]
    jargs = [jmaps[0], *map(jnp.asarray, vecs[:2])]
    targs = [tmaps[0], *map(torch.from_numpy, vecs[:2])]
    if noise:
        jargs += [jnp.asarray(vecs[2]), *jmaps[1:]]
        targs += [torch.from_numpy(vecs[2]), *tmaps[1:]]
    return jargs, targs


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(dtype, noise):
    """out, bmean and bvar. Statistics in f32 from the same inputs:
    rel-max 1e-5 in both dtypes. out: rel-max 1e-5 in f32, 2 ulps at its
    magnitude in bf16."""
    jdt, tdt = DTYPES[dtype]
    jop, top = _ops(noise)
    jargs, targs = _operands(noise, jdt, tdt, seed=0)
    out_j, mean_j, var_j = jop(*jargs)
    out_t, mean_t, var_t = top(*targs)
    assert out_t.dtype == tdt and out_t.shape == targs[0].shape
    assert mean_t.dtype == var_t.dtype == torch.float32
    assert _rel(mean_t.numpy(), np.asarray(mean_j)) <= F32_TOL
    assert _rel(var_t.numpy(), np.asarray(var_j)) <= F32_TOL
    ours, ref = _nhwc(out_t), np.asarray(out_j.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(ours, ref) <= F32_TOL
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(ours - ref).max() <= BF16_ULPS * ulp


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_vjp_matches_jax(noise):
    """f32 gradients of every input under random cotangents on all three
    outputs (out, bmean, bvar), so the statistics' cotangents g_mean and
    g_var take part: rel-max 1e-5 per gradient."""
    jop, top = _ops(noise)
    jargs, targs = _operands(noise, jnp.float32, torch.float32, seed=1)
    rng = np.random.default_rng(2)
    c = SHAPE[-1]
    g_out = rng.normal(size=SHAPE).astype(np.float32)
    g_mean = rng.normal(size=c).astype(np.float32)
    g_var = rng.normal(size=c).astype(np.float32)
    _, vjp = jax.vjp(jop, *jargs)
    grads_j = vjp((jnp.asarray(g_out), jnp.asarray(g_mean), jnp.asarray(g_var)))
    for t in targs:
        t.requires_grad_(True)
    outs = top(*targs)
    grads_t = torch.autograd.grad(
        outs, targs, (_nchw(g_out), torch.from_numpy(g_mean), torch.from_numpy(g_var))
    )
    names = ["x", "scale", "bias", "w", "n_l", "n_g"]
    for name, ours, ref in zip(names, grads_t, grads_j):
        ours = _nhwc(ours) if ours.dim() == 4 else ours.numpy()
        assert ours.shape == ref.shape, name
        assert _rel(ours, np.asarray(ref)) <= F32_TOL, name


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_coupled_backward_matches_autograd_of_the_chain(noise):
    """The backward passes (reduce, then dx with the statistics'
    cotangents) against torch autograd through the plain forward chain, in
    f64: rel-max 1e-10 per gradient."""
    rng = np.random.default_rng(3)
    x, scale, bias, w, n_l, n_g = _data(4)
    x, n_l, n_g = (_nchw(a, torch.float64) for a in (x, n_l, n_g))
    scale, bias, w = (torch.from_numpy(a).double() for a in (scale, bias, w))
    g_out = torch.from_numpy(rng.normal(size=x.shape))
    g_mean, g_var = (torch.from_numpy(rng.normal(size=x.shape[1])) for _ in range(2))
    inputs = [x, scale, bias] + ([w, n_l, n_g] if noise else [])
    for t in inputs:
        t.requires_grad_(True)
    chain = (lambda *a: tbn.bn_gelu_noise_chain_plain(*a, CL)) if noise else tbn.bn_gelu_chain_plain
    want = torch.autograd.grad(chain(*inputs), inputs, (g_out, g_mean, g_var))

    with torch.no_grad():
        mean, var = tbn.bn_stats_plain(x)
        sums = tbn.bn_bwd_reduce_plain(x, g_out, mean, var, scale, bias,
                                       *((n_l, n_g, CL) if noise else ()))
        dx = tbn.bn_bwd_dx_plain(x, g_out, mean, var, scale, bias, sums[0], sums[1],
                                 g_mean, g_var, *((w, CL) if noise else ()))
    got = [dx[0], sums[1], sums[0], sums[2], dx[1], dx[2]] if noise else [dx, sums[1], sums[0]]
    for ours, ref in zip(got, want):
        assert ours.shape == ref.shape
        assert ((ours - ref).abs().max() / ref.abs().max()).item() <= 1e-10


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers give their plain version's values and
    count no kernel launch."""
    x, scale, bias, w, n_l, n_g = _data(5)
    x, n_l, n_g = _nchw(x), _nchw(n_l), _nchw(n_g)
    scale, bias, w = map(torch.from_numpy, (scale, bias, w))
    wrappers = (tbn.bn_stats, tbn.bn_gelu_apply, tbn.bn_bwd_reduce, tbn.bn_bwd_dx)
    before = [f.launches for f in wrappers]
    mean, var = tbn.bn_stats(x)
    torch.testing.assert_close((mean, var), tbn.bn_stats_plain(x), rtol=0, atol=0)
    out = tbn.bn_gelu_apply(x, mean, var, scale, bias, w, n_l, n_g, CL)
    assert torch.equal(out, tbn.bn_gelu_apply_plain(x, mean, var, scale, bias, w, n_l, n_g, CL))
    sums = tbn.bn_bwd_reduce(x, out, mean, var, scale, bias, n_l, n_g, CL)
    assert len(sums) == 3
    dx, dn_l, dn_g = tbn.bn_bwd_dx(x, out, mean, var, scale, bias, sums[0], sums[1], w=w, cl=CL)
    assert dx.shape == x.shape and dn_l.shape == dn_g.shape == n_l.shape
    assert [f.launches for f in wrappers] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, 4, 4)
    vec = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        tbn.bn_gelu_apply(x, vec, vec, vec, torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tbn.bn_stats(x.half())
    with pytest.raises(ValueError, match="cl"):
        tbn.bn_gelu_apply(x, vec, vec, vec, vec, vec, torch.zeros(2, 1, 4, 4),
                          torch.zeros(2, 1, 4, 4), cl=9)
    with pytest.raises(ValueError, match="n_l"):
        tbn.bn_gelu_apply(x, vec, vec, vec, vec, vec, torch.zeros(2, 2, 4, 4),
                          torch.zeros(2, 1, 4, 4), cl=4)
