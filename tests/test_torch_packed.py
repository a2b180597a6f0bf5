"""The port's packed-branch mode against the JAX package's and against the
port's own tuple path (CPU, f32).

Packed mode keeps the local and global branches in one map, local
channels first: one convolution with a block-structured kernel (the g→g
block zero) and one BN + activation pass with per-channel statistics. It
computes the tuple path's function, with the same parameters.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.models import FFCGenerator as JFFCGenerator
from fastfourierconvolution_tpu.nn import layers as jlayers
from fastfourierconvolution_tpu.nn.ffc import FFC_BN_ACT as JFFC_BN_ACT
from fastfourierconvolution_tpu.nn.ffc import Packed as JPacked
from fastfourierconvolution_tpu_torch import FFCGenerator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn import layers as tlayers
from fastfourierconvolution_tpu_torch.nn.ffc import FFC_BN_ACT, Packed
from fastfourierconvolution_tpu_torch.ops import bn_act

from test_torch_ffc import nchw, nhwc, seeded_variables

# (in_ch, out_ch, k, ratio_gin, ratio_gout, stride, padding, upsampling, act)
CASES = {
    # a generator block (transposed, with the upsampling g2g SpectralTransform)
    "block": (32, 32, 4, 0.5, 0.5, 2, 1, True, "gelu"),
    # the first block: all-local input, so no g→l, g→g branches
    "first_block": (32, 32, 4, 0.0, 0.5, 2, 1, True, "gelu"),
    # a plain FFC with the pooling g2g SpectralTransform
    "conv": (32, 32, 3, 0.5, 0.5, 2, 1, False, "relu"),
    # the generator's head: no norm, all-local output
    "to_rgb": (16, 3, 3, 0.5, 0.0, 1, 1, False, "tanh"),
}
# Outputs, absolute, on O(1) values: a convolution, a FourierUnit and a
# second convolution chained in f32, summed in other orders.
OUT_TOL = 1e-4
# Running statistics after a training call, absolute: a 0.1 share of f32
# batch statistics.
STATE_TOL = 1e-5


@contextlib.contextmanager
def fast_gelu(on: bool):
    """The tanh-form GELU on both sides for every dtype (the port's fused
    BN+GELU op runs only where the tanh form applies)."""
    old_j, old_t = jlayers._FAST_GELU, tlayers._FAST_GELU
    jlayers.set_fast_gelu(on)
    tlayers.set_fast_gelu(on if on else "policy")
    try:
        yield
    finally:
        jlayers._FAST_GELU, tlayers._FAST_GELU = old_j, old_t


def _modules(case):
    cin, cout, k, rin, rout, s, p, up, act = CASES[case]
    kw = dict(stride=s, padding=p, upsampling=up, activation=act,
              norm="identity" if act == "tanh" else "batch", packed=True)
    return (JFFC_BN_ACT(cin, cout, k, rin, rout, **kw),
            FFC_BN_ACT(cin, cout, k, rin, rout, **kw), cin - int(cin * rin))


# mode: "eval" (running statistics), "train" (batch statistics, exact-erf
# GELU in f32), "train_fused" (tanh GELU and a noise fold: the port's fused
# BN+GELU op, here its plain versions; GELU blocks only)
MODES = [(case, mode) for case in sorted(CASES) for mode in ("eval", "train", "train_fused")
         if mode != "train_fused" or CASES[case][-1] == "gelu"]


@pytest.mark.parametrize("case,mode", MODES)
def test_packed_ffc_bn_act_matches_jax(case, mode):
    jmod, tmod, cl_in = _modules(case)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, CASES[case][0])).astype(np.float32)
    jx = JPacked(jnp.asarray(x), cl_in)
    train = mode != "eval"
    shapes = jax.eval_shape(
        lambda x: jmod.init({"params": jax.random.PRNGKey(0)}, JPacked(x, cl_in), train),
        jx.x,
    )
    variables = seeded_variables(shapes, seed=8)
    tmod.load_state_dict(jax_to_state_dict(tmod, variables["params"],
                                           variables.get("batch_stats", {})))
    fold_j = fold_t = None
    if mode == "train_fused":
        c, hw = CASES[case][1], 16
        w = rng.normal(size=c).astype(np.float32) * 0.3
        n_l, n_g = (rng.normal(size=(2, hw, hw, 1)).astype(np.float32) for _ in range(2))
        fold_j = (jnp.asarray(w), jnp.asarray(n_l), jnp.asarray(n_g))
        fold_t = (torch.from_numpy(w), nchw(n_l), nchw(n_g))
    with fast_gelu(mode == "train_fused"):
        out_j, updates = jmod.apply(variables, jx, train, noise_fold=fold_j,
                                    mutable=["batch_stats"])
        before = bn_act.bn_gelu_apply.launches
        with torch.set_grad_enabled(train):
            out_t = tmod.train(train)(Packed(nchw(x), cl_in), noise_fold=fold_t)
    assert isinstance(out_t, Packed) and out_t.cl == out_j.cl
    assert out_t.x.shape[1:] == (out_j.x.shape[3], *out_j.x.shape[1:3])
    np.testing.assert_allclose(nhwc(out_t.x.detach()), np.asarray(out_j.x), atol=OUT_TOL)
    assert bn_act.bn_gelu_apply.launches == before  # CPU: plain versions, no kernel
    if train and CASES[case][-1] != "tanh":
        theirs = jax_to_state_dict(tmod, variables["params"], updates["batch_stats"])
        for name, value in tmod.state_dict().items():
            if "running" in name:
                np.testing.assert_allclose(value.numpy(), theirs[name].numpy(),
                                           atol=STATE_TOL, err_msg=name)


def test_block_kernel_layouts():
    """The assembled kernel holds each branch's weight in its block, OIHW
    for a convolution and IOHW for a transposed one, with a zero g→g
    block."""
    for case, transposed in (("conv", False), ("block", True)):
        _, tmod, _ = _modules(case)
        tlayers.reset_parameters(tmod, torch.Generator().manual_seed(0))
        ffc = tmod.ffc
        (in_cl, in_cg), (out_cl, out_cg) = ffc.in_split, ffc.out_split
        k = ffc.block_kernel()
        kt = k.transpose(0, 1) if transposed else k  # now (out, in, kh, kw)
        assert kt.shape[:2] == (out_cl + out_cg, in_cl + in_cg)
        assert torch.equal(kt[:out_cl, :in_cl], _oi(ffc.convl2l.weight, transposed))
        assert torch.equal(kt[out_cl:, :in_cl], _oi(ffc.convl2g.weight, transposed))
        assert torch.equal(kt[:out_cl, in_cl:], _oi(ffc.convg2l.weight, transposed))
        assert not kt[out_cl:, in_cl:].any()


def _oi(w, transposed):
    return w.transpose(0, 1) if transposed else w


NARROW_128 = dict(z_size=16, ngf=8, ratio_g=0.5, mg=2, channel_mults=(4, 2, 1, 1, 1))


def test_packed_generator_matches_tuple_generator():
    """The port's packed generator against its tuple generator with the
    same weights (noise weights made non-zero) and the same noise
    generator, in training: outputs, every parameter gradient and the
    running statistics equal within f32 rounding (rel-max 1e-5); in eval,
    outputs within 1e-5."""
    gens = [FFCGenerator(**NARROW_128, packed=p, generator=torch.Generator().manual_seed(0))
            for p in (False, True)]
    tuple_g, packed_g = gens
    with torch.no_grad():
        for name, p in tuple_g.named_parameters():
            if "noise" in name:
                p.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
    packed_g.load_state_dict(tuple_g.state_dict())
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
    grads, outs = [], []
    for g in gens:
        y = g.train()(z, torch.float32, torch.Generator().manual_seed(3))
        outs.append(y)
        grads.append(torch.autograd.grad(y.square().sum(), list(g.parameters())))
    assert outs[0].shape == (4, 3, 64, 64)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    assert rel(outs[1], outs[0]) <= 1e-5
    for (name, _), a, b in zip(tuple_g.named_parameters(), grads[1], grads[0]):
        assert rel(a, b) <= 1e-5, name
    s_t, s_p = tuple_g.state_dict(), packed_g.state_dict()
    for name in s_t:
        assert rel(s_p[name], s_t[name]) <= 1e-5, name
    with torch.no_grad():
        np.testing.assert_allclose(packed_g.eval()(z).numpy(), tuple_g.eval()(z).numpy(),
                                   atol=1e-5)


def test_packed_is_the_default_from_128px():
    assert FFCGenerator.for_resolution(128, ngf=8).packed
    assert not FFCGenerator.for_resolution(32).packed
    assert not FFCGenerator.for_resolution(128, ngf=8, packed=False).packed


def test_full_width_128px_packed_generator_bridge():
    """The 128px preset at full width, packed on both sides: the bridge
    takes every JAX leaf of the params and batch statistics once (the
    packed path's conv, BN and noise holders) and fills every port
    entry."""
    jg = JFFCGenerator.for_resolution(128, z_size=128)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jg.init(rngs, z, True), jnp.zeros((2, 128)))
    variables = seeded_variables(shapes, seed=3)
    model = FFCGenerator.for_resolution(128)
    assert model.packed
    state = jax_to_state_dict(model, variables["params"], variables["batch_stats"])
    assert set(state) == set(model.state_dict())
    assert sum(t.numel() for t in state.values()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state)
