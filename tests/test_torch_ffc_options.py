"""The FFC layer options against the JAX package (CPU, f32): dilation and
groups on the convolutions, the local Fourier unit (``enable_lfu``),
spectral norm (``use_sn``) on plain and transposed FFCs, and biases on
transposed and packed FFCs; then packed against tuple and the refusals.

The JAX module is initialised, its variables are replaced by seeded
numpy values at unit signal scale (``seeded_variables``), and the same
variables reach the port through the bridge. Each case runs one forward
in training (batch statistics; every running statistic and ``u``
advances) or in eval mode, and the gradients of a scalar loss, the sum of
the output times a seeded map, in every parameter and in the input:
``torch.autograd`` against ``jax.grad``. The JAX FourierUnit runs its
fused op with its custom VJP, as the JAX package's tests run it on the
CPU.

Bars: outputs and gradients per tensor ``TOL`` of the reference's
largest magnitude (f32 on both sides, the same math summed in other
orders: XLA against oneDNN convolutions, factor-form DFTs); running
statistics and ``u`` ``STATE_TOL`` absolute. A conv bias that feeds
BatchNorm in training is subtracted again with the batch mean: its
gradient is 0 up to rounding on each side on its own, so both sides' are
held to ``TOL`` of the module's largest gradient instead (``FREE_BIAS``).
"""

from __future__ import annotations

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.nn import ffc as jffc
from fastfourierconvolution_tpu.nn import layers as jlayers
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn import ffc as tffc
from fastfourierconvolution_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, reset_parameters

from test_torch_ffc import nchw, nhwc, seeded_variables

TOL = 1e-4
STATE_TOL = 1e-5
BATCH = 2
FREE_BIAS = re.compile(r"ffc\.conv(l2l|l2g|g2l)\.bias")


def _rel(ours: np.ndarray, ref, what: str) -> None:
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _bridge(port, variables, updates=None):
    updates = updates or {}
    return jax_to_state_dict(port, variables["params"],
                             updates.get("batch_stats", variables.get("batch_stats")),
                             updates.get("spectral", variables.get("spectral")))


def check_module(jmod, port, xs, train, jinput=lambda xs: xs[0], pinput=lambda xs: xs[0],
                 seed=1, free=re.compile("(?!)")):
    """``jmod`` (flax) and ``port`` on the NHWC inputs ``xs`` (numpy, f32),
    which ``jinput`` / ``pinput`` turn into each side's argument (the port
    gets them NCHW): output, the state after the forward, and the
    gradients of sum(out * w) in every parameter and input, those of the
    parameters that ``free`` matches near 0 on both sides."""
    rng = np.random.default_rng(seed)
    jxs = [jnp.asarray(x) for x in xs]
    shapes = jax.eval_shape(lambda v: jmod.init(jax.random.PRNGKey(0), jinput(v), train), jxs)
    variables = seeded_variables(shapes, seed)
    out_shape = jax.eval_shape(lambda v: jffc.resize_output(jmod.apply(
        variables, jinput(v), train, mutable=["batch_stats", "spectral"])[0]), jxs).shape
    w = rng.normal(size=out_shape).astype(np.float32)

    def loss(params, v):
        out, upd = jmod.apply({**variables, "params": params}, jinput(v), train,
                              mutable=["batch_stats", "spectral"])
        out = jffc.resize_output(out)
        return jnp.sum(out * w), (out, upd)

    (_, (out, upd)), (g_params, g_xs) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jxs)

    port.load_state_dict(_bridge(port, variables))
    port.train(train)
    pxs = [nchw(x).requires_grad_(True) for x in xs]
    ours = tffc.resize_output(port(pinput(pxs)))
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((ours * nchw(w)).sum(), list(params.values()) + pxs)
    _rel(nhwc(ours.detach()), out, "output")
    assert np.asarray(out).std() > 1e-3  # a real signal, not a flat 0
    after = _bridge(port, variables, upd)
    with torch.no_grad():
        for name, value in port.state_dict().items():
            if name not in params:
                np.testing.assert_allclose(value.numpy(), after[name].numpy(), atol=STATE_TOL,
                                           err_msg=name)
    theirs = _bridge(port, {**variables, "params": g_params})
    scale = max(t.abs().max().item() for n, t in theirs.items() if n in params)
    for (name, _), g in zip(params.items(), grads):
        if free.fullmatch(name):
            for side in (g, theirs[name]):
                assert side.abs().max().item() <= TOL * scale, (name, side)
            continue
        _rel(g.numpy(), theirs[name].numpy(), f"gradient of {name}")
    for i, (g, ref) in enumerate(zip(grads[len(params):], g_xs)):
        _rel(nhwc(g), ref, f"gradient of input {i}")
    return port, variables, upd


# --- convolutions ------------------------------------------------------------------


class _JaxConv(fnn.Module):
    """A JAX conv layer behind the ``(x, train)`` call of the FFC modules."""

    conv: fnn.Module

    @fnn.compact
    def __call__(self, x, train):
        return self.conv(x)


class _PortConv(torch.nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


# (transposed, stride, padding, dilation, groups)
CONV_CASES = {
    "dilated": (False, 1, 2, 2, 1),
    "grouped": (False, 2, 1, 1, 4),
    "dilated-grouped": (False, 1, 2, 2, 2),
    "t-dilated": (True, 2, 1, 2, 1),
    "t-grouped": (True, 2, 1, 1, 4),
    "t-dilated-grouped": (True, 1, 2, 2, 2),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_dilation_and_groups_match_jax(case):
    """k3 convolutions (transposed ones too) with dilation and groups, 8
    channels to 12, with a bias: outputs and gradients (the bridge turns a
    grouped transposed kernel's JAX layout into torch's)."""
    transposed, stride, padding, dilation, groups = CONV_CASES[case]
    x = np.random.default_rng(0).normal(size=(BATCH, 6, 6, 8)).astype(np.float32)
    jargs = dict(stride=stride, padding=padding, dilation=dilation, groups=groups, use_bias=True)
    targs = dict(bias=True, dilation=dilation, groups=groups)
    if transposed:
        jconv = jlayers.ConvTranspose2d(12, 3, **jargs)
        port = ConvTranspose2d(8, 12, 3, stride, padding, **targs)
    else:
        jconv, port = jlayers.Conv2d(12, 3, **jargs), Conv2d(8, 12, 3, stride, padding, **targs)
    check_module(_JaxConv(jconv), _PortConv(port), [x], train=True)


# --- the spectral transform's local Fourier unit ----------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("stride,groups,use_se", [(1, 1, True), (2, 2, True), (1, 1, False)],
                         ids=["s1", "s2-groups2", "s1-no-se"])
def test_spectral_transform_with_lfu_matches_jax(stride, groups, use_se, train):
    """SpectralTransform(enable_lfu=True), 8 channels to 16 on 8x8 maps
    (stride 2: pooled to 4x4): the bottleneck's first 2 channels folded
    into 8 at half the size, through ``lfu``, tiled back; with ``groups``
    on both 1x1 convolutions, and without the SE gate. Output, the three
    BNs' running statistics (bottleneck, FourierUnit, LFU) and the
    gradients."""
    x = np.random.default_rng(2).normal(size=(BATCH, 8, 8, 8)).astype(np.float32)
    jmod = jffc.SpectralTransform(16, stride=stride, groups=groups, enable_lfu=True,
                                  use_se=use_se, impl="dft")
    port = tffc.SpectralTransform(8, 16, stride=stride, groups=groups, enable_lfu=True,
                                  use_se=use_se)
    port, _, upd = check_module(jmod, port, [x], train)
    assert port.lfu is not None and port.lfu.running_mean.shape == (16,)
    if train:
        assert "lfu" in upd["batch_stats"]


# --- FFC_BN_ACT: every option -----------------------------------------------------

# name -> (in, out, k, ratio_gin, ratio_gout, stride, padding, keywords)
FFC_CASES = {
    "lfu-up": (16, 32, 4, 0.5, 0.5, 2, 1, dict(upsampling=True, enable_lfu=True, norm="batch",
                                                activation="gelu")),
    "lfu-pool": (32, 32, 3, 0.5, 0.5, 2, 1, dict(enable_lfu=True, norm="batch",
                                                  activation="relu")),
    "lfu-packed-bias": (16, 32, 4, 0.5, 0.5, 2, 1, dict(upsampling=True, enable_lfu=True,
                                                         packed=True, use_bias=True,
                                                         norm="batch", activation="gelu")),
    "sn": (16, 16, 3, 0.5, 0.5, 1, 1, dict(use_sn=True, use_bias=True, norm="batch",
                                           activation="leaky_relu")),
    "sn-transposed": (16, 16, 4, 0.5, 0.5, 2, 1, dict(use_sn=True, upsampling=True,
                                                      activation="gelu")),
    "sn-transposed-bias": (16, 16, 4, 0.25, 0.5, 2, 1, dict(use_sn=True, use_bias=True,
                                                            upsampling=True, norm="batch",
                                                            activation="relu")),
    "bias-transposed": (16, 16, 4, 0.25, 0.5, 2, 1, dict(use_bias=True, upsampling=True,
                                                         norm="batch", activation="relu")),
    "bias-packed": (16, 16, 3, 0.5, 0.5, 1, 1, dict(use_bias=True, packed=True, norm="batch",
                                                    activation="gelu")),
    "bias-packed-local-out": (16, 8, 3, 0.5, 0.0, 1, 1, dict(use_bias=True, packed=True,
                                                             activation="tanh")),
    "groups-dilation": (16, 16, 3, 0.5, 0.5, 1, 2, dict(groups=4, dilation=2, norm="batch",
                                                        activation="relu")),
    "groups-dilation-transposed": (16, 16, 3, 0.5, 0.5, 1, 2, dict(
        groups=2, dilation=2, upsampling=True, use_bias=True, norm="batch",
        activation="gelu")),
    "dilation-packed": (16, 16, 3, 0.5, 0.5, 1, 2, dict(dilation=2, packed=True, norm="batch",
                                                        activation="relu")),
}


def _ffc_inputs(case):
    cin, _, _, rin, _, stride, _, kw = FFC_CASES[case]
    size = 4 if kw.get("upsampling") else 8
    cg = int(cin * rin)
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(BATCH, size, size, c)).astype(np.float32) for c in (cin - cg, cg)]
    if kw.get("packed"):
        cl = cin - cg
        return ([np.concatenate(xs, axis=-1)], lambda v: jffc.Packed(v[0], cl),
                lambda v: tffc.Packed(v[0], cl))
    return xs, tuple, tuple


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(FFC_CASES))
def test_ffc_bn_act_option_matches_jax(case, train):
    """FFC_BN_ACT with each option against the JAX block (FFCTranspose
    where ``upsampling``): output, running statistics and ``u`` after the
    forward (in training every ``u`` advances one power iteration; in eval
    none moves), and the gradients in every parameter and input. The LFU
    cases run their FourierUnits on 4x4 (upsampling, 8x8 out) and 2x2
    (pooled) LFU maps."""
    cin, cout, k, rin, rout, stride, padding, kw = FFC_CASES[case]
    xs, jinput, pinput = _ffc_inputs(case)
    jmod = jffc.FFC_BN_ACT(cin, cout, k, rin, rout, stride=stride, padding=padding,
                           impl="dft", **kw)
    port = tffc.FFC_BN_ACT(cin, cout, k, rin, rout, stride=stride, padding=padding, **kw)
    free = FREE_BIAS if train and kw.get("norm") == "batch" else re.compile("(?!)")
    _, variables, upd = check_module(jmod, port, xs, train, jinput, pinput, free=free)
    if kw.get("use_sn"):
        moved = [not np.allclose(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(variables["spectral"]),
            jax.tree_util.tree_leaves(upd["spectral"]))]
        assert all(moved) if train else not any(moved)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transposed"])
def test_packed_bias_equals_the_tuple_path(transpose):
    """A packed FFC with biases gives the tuple path's output on the same
    weights: the block bias sums l2l and g2l on the local channels and
    takes l2g on the global ones. 1e-5 absolute, f32, in training."""
    common = dict(stride=2, padding=1, use_bias=True, transpose=transpose)
    tuple_ffc = tffc.FFC(16, 24, 4, 0.25, 0.5, **common)
    packed = tffc.FFC(16, 24, 4, 0.25, 0.5, packed=True, **common)
    reset_parameters(tuple_ffc, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in tuple_ffc.modules():
            if getattr(m, "bias", None) is not None and isinstance(m.bias, torch.nn.Parameter):
                m.bias.normal_(0, 0.5, generator=torch.Generator().manual_seed(1))
    packed.load_state_dict(tuple_ffc.state_dict())
    x = torch.randn(2, 16, 4 if transpose else 8, 4 if transpose else 8,
                    generator=torch.Generator().manual_seed(2))
    out_t = tffc.resize_output(tuple_ffc((x[:, :12], x[:, 12:])))
    out_p = tffc.resize_output(packed(tffc.Packed(x, 12)))
    torch.testing.assert_close(out_p, out_t, rtol=0, atol=1e-5)
    assert packed.block_bias().shape == (24,)
    torch.testing.assert_close(packed.block_bias()[:12],
                               packed.convl2l.bias + packed.convg2l.bias)


REFUSED = [
    (dict(packed=True, use_sn=True), "packed mode"),
    (dict(packed=True, groups=2), "packed mode"),
    (dict(use_sn=True, dilation=2), "use_sn"),
    (dict(use_sn=True, groups=2), "use_sn"),
    (dict(use_sn=True, groups=2, upsampling=True), "use_sn"),
    (dict(groups=3), "groups=3"),
]


@pytest.mark.parametrize("keywords,match", REFUSED, ids=lambda v: str(v)[:32])
def test_invalid_combinations_raise_value_error(keywords, match):
    with pytest.raises(ValueError, match=match):
        tffc.FFC_BN_ACT(16, 16, 3, 0.5, 0.5, padding=1, **keywords)


def test_lfu_refuses_what_it_cannot_fold():
    """The bottleneck must split in four (16 channels out: 8, yes; 8 out: 4,
    yes; 12 out: 6, no), and the map must be even."""
    with pytest.raises(ValueError, match="divisible by 4"):
        tffc.SpectralTransform(8, 12, enable_lfu=True)
    st = tffc.SpectralTransform(8, 16, enable_lfu=True)
    with pytest.raises(ValueError, match="even spatial dims"):
        st(torch.zeros(2, 8, 6, 5))
