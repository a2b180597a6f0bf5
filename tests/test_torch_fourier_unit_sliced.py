"""The FourierUnit's sliced design on the CPU, against the JAX package.

Where no per-item plan holds the mix K (2C x 2C) but one holds a slice of
its out-channels (the SN cDCGAN discriminator's (256, 4, 4)),
``fu_train_stats``, ``fu_bwd_stats`` and ``fu_bwd_apply`` run their
clustered kernels on T out-channel slices in series
(``fourier_unit.kernel_design`` ``SLICED``): the slices' statistics and
backward sums placed in the [re | im] layout before one reduction, their gK
columns placed the same way, their partial gx added in slice order. The
kernels cannot run here, so the composition (``slice_operands``,
``sliced_rows``, ``sliced_apply``, ``place_columns``) runs with each
slice's plain version standing in for its kernel, and is held against the
JAX FourierUnit's train forward and custom VJP (``fourier_unit_fused``,
whose backward is ``_jnp_backward``) on inputs made with numpy from a seed.
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

SHAPE = (2, 4, 4, 16)  # (B, H, W, C): a narrow map of the discriminator's 4 x 4
SLICE_TOL = 1e-5  # f32 rel-max: the same sums as JAX's, in other orders


def _stats_rows(x, kslice, _vectors, _gy):
    """One slice's per-item rows [Σm | Σm²] over (H, Wf), as the clustered
    statistics kernel writes them."""
    _, m = tfu._spectrum_plain(x, kslice)
    return torch.cat([m.sum(dim=(2, 3)), (m * m).sum(dim=(2, 3))], dim=1)


def _bwd_stats_rows(x, kslice, vectors, gy):
    """One slice's per-item rows [Σgpre·n̂ | Σgpre], as the clustered
    backward-sums kernel writes them; vectors (scale, bias, bmean, bvar)."""
    _, n_hat, _, gpre = tfu._bwd_recompute_plain(x, kslice, *vectors, gy)
    return torch.cat([(gpre * n_hat).sum(dim=(2, 3)), gpre.sum(dim=(2, 3))], dim=1)


def _sliced(x, kernel, scale, bias, gy, t):
    """(bmean, bvar, gx, gK, gscale, gbias) of the sliced design's
    composition with the slices' plain versions."""
    b, _, h, w = x.shape
    co2 = kernel.shape[1]
    rows = tfu.sliced_rows(lambda k, v, g: _stats_rows(x, k, v, g), t, kernel)
    bmean, bvar = tfu.fu_reduce_plain(rows, b * h * (w // 2 + 1)).split(co2)
    vectors = (scale, bias, bmean, bvar)
    rows = tfu.sliced_rows(lambda k, v, g: _bwd_stats_rows(x, k, v, g), t, kernel, vectors, gy)
    gscale, gbias = tfu.fu_reduce_plain(rows).split(co2)
    gx, gk = tfu.sliced_apply(lambda k, v, g: tfu.fu_bwd_apply_plain(x, k, *v[:4], g, *v[4:]),
                              t, kernel, (*vectors, gscale, gbias), gy)
    return bmean, bvar, gx, gk, gscale, gbias


@pytest.mark.parametrize("t", [2, 4])
def test_slice_operands_are_the_out_columns_and_place_inverts_them(t):
    x, kernel, scale, bias, gy = _port(*_train_inputs(SHAPE, seed=30))
    c = x.shape[1]
    ops = tfu.slice_operands(t, kernel, (scale, bias), gy)
    for i, (ks, (s, b_), g) in enumerate(ops):
        cols = tfu.out_columns(c, i, t)
        assert ks.is_contiguous() and torch.equal(ks, kernel[:, cols])
        assert torch.equal(s, scale[cols]) and torch.equal(b_, bias[cols])
        assert g.is_contiguous() and torch.equal(g, gy[:, i * c // t:(i + 1) * c // t])
    assert torch.equal(tfu.place_columns(torch.stack([o[0] for o in ops])), kernel)
    assert torch.equal(tfu.place_columns(torch.stack([o[1][0] for o in ops])), scale)


@pytest.mark.parametrize("t", [2, 4])
def test_sliced_composition_matches_jax(t):
    """The statistics, the backward sums, gK and gx of T slices against the
    JAX FourierUnit's train forward and jax.vjp of its custom VJP, f32:
    SLICE_TOL rel-max each."""
    x, kernel, scale, bias, gy = _train_inputs(SHAPE, seed=31)
    xt, kt, st, bt, gyt = _port(x, kernel, scale, bias, gy)
    bmean, bvar, gx, gk, gscale, gbias = _sliced(xt, kt, st, bt, gyt, t)
    c2 = kernel.shape[0]
    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias)) + (jnp.zeros(c2),
                                                                       jnp.ones(c2))
    (_, m_j, v_j), vjp = jax.vjp(lambda *a: jfu.fourier_unit_fused(*a, True), *args)
    gx_j, gk_j, gs_j, gb_j = vjp((jnp.asarray(gy), jnp.zeros_like(m_j),
                                  jnp.zeros_like(v_j)))[:4]
    got = {"bmean": bmean.numpy(), "bvar": bvar.numpy(), "gx": _nhwc(gx), "gK": gk.numpy(),
           "gscale": gscale.numpy(), "gbias": gbias.numpy()}
    want = {"bmean": m_j, "bvar": v_j, "gx": gx_j, "gK": gk_j, "gscale": gs_j, "gbias": gb_j}
    for name in got:
        assert _rel_max(got[name], want[name]) <= SLICE_TOL, (name, _rel_max(got[name],
                                                                               want[name]))


@pytest.mark.parametrize("t", [2, 4])
def test_sliced_composition_is_the_whole_plain_op_in_f64(t):
    """In f64 the composition gives the whole FourierUnit's plain
    statistics and backward to 1e-12 rel-max."""
    x, kernel, scale, bias, gy = (a.double() for a in _port(*_train_inputs(SHAPE, seed=32)))
    bmean, bvar, gx, gk, gscale, gbias = _sliced(x, kernel, scale, bias, gy, t)
    want_stats = tfu.fu_train_stats_plain(x, kernel)
    want_sums = tfu.fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)
    want_apply = tfu.fu_bwd_apply_plain(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias)
    for got, want in zip((bmean, bvar, gscale, gbias, gx, gk),
                         (*want_stats, *want_sums, *want_apply)):
        assert _rel_max(got, want) <= 1e-12
