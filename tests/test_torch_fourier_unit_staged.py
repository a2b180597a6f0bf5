"""The FourierUnit's staged design on the CPU: which maps take it, and its
stages' plain versions against the JAX package.

On a CUDA tensor ``fourier_unit_forward``, ``fu_bwd_apply``, the statistics
(``fu_train_stats``, ``fu_bwd_stats``) and the training op run a map as the
per-item kernels or as the staged kernels (``fu_spectrum``,
``fu_mix_stats`` / ``fu_bwd_stats_mix``, ``fu_mix_apply`` / ``fu_bwd_mix``,
``fu_inverse``), by the rule of ``kernel_design``. Here the stages' plain
versions, composed as the wrappers and the training op compose the
kernels, are held against the JAX FourierUnit (forward and custom VJP) on
inputs made with numpy from a seed, NHWC to JAX and NCHW to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.ops import fourier as jfourier
from fastfourierconvolution_tpu.ops.pallas import fourier_unit as jfu
from fastfourierconvolution_tpu_torch.ops import fourier_unit as tfu

from test_torch_fourier_unit_train import _nhwc, _port, _rel_max, _train_inputs

H100_SMEM = 232448  # shared memory a block may take on an H100, bytes
SHAPES = [(4, 8, 8, 8), (2, 16, 16, 8), (2, 8, 32, 8)]  # (B, H, W, C), H and W powers of two
# Planes that are no power of two, which the kernels take with dense DFT
# stages (the 96px generator's 96 x 96 at a CPU test's size).
DENSE_SHAPES = [(2, 6, 12, 8), (2, 12, 24, 8)]
STAGE_WRAPPERS = (tfu.fu_spectrum, tfu.fu_mix_apply, tfu.fu_inverse, tfu.fu_bwd_mix,
                  tfu.fu_mix_stats, tfu.fu_bwd_stats_mix)


@pytest.mark.parametrize("wrapper,cmap,limit,design", [
    # the 32px generator's maps keep the per-item kernels in shared memory
    ("forward", (16, 16, 16), H100_SMEM, tfu.SHARED),
    ("forward", (8, 32, 32), H100_SMEM, tfu.SHARED),
    ("bwd_apply", (16, 16, 16), H100_SMEM, tfu.SHARED),
    ("bwd_apply", (8, 32, 32), H100_SMEM, tfu.SHARED),
    # the 128px generator's: the forward at (64, 16, 16) still fits
    ("forward", (64, 16, 16), H100_SMEM, tfu.SHARED),
    ("bwd_apply", (64, 16, 16), H100_SMEM, tfu.STAGED),
    ("forward", (32, 32, 32), H100_SMEM, tfu.STAGED),
    ("bwd_apply", (32, 32, 32), H100_SMEM, tfu.STAGED),
    ("forward", (32, 64, 64), H100_SMEM, tfu.STAGED),
    ("bwd_apply", (32, 64, 64), H100_SMEM, tfu.STAGED),
    ("forward", (32, 128, 128), H100_SMEM, tfu.STAGED),
    ("bwd_apply", (32, 128, 128), H100_SMEM, tfu.STAGED),
    # a smaller limit moves a 32px map to the staged kernels
    ("forward", (8, 32, 32), 48 * 1024, tfu.STAGED),
    ("forward", (16, 16, 16), 48 * 1024, tfu.SHARED),
    # planes that are no power of two: dense DFT stages (the workspace
    # before the staged kernels took them)
    ("forward", (8, 96, 96), H100_SMEM, tfu.STAGED),
    # 2C above 128: the statistics and the backward apply on 4 out-channel
    # slices (the workspace before the sliced design)
    ("bwd_apply", (128, 16, 16), H100_SMEM, tfu.SLICED),
    # the 256px generator's 256 x 256, a plane beyond one block: staged on
    # planes split over two blocks (the workspace before the split)
    ("bwd_apply", (32, 256, 256), H100_SMEM, tfu.STAGED),
    ("forward", (32, 256, 256), H100_SMEM, tfu.STAGED),
    # maps no other design takes: the per-item kernel's workspace
    ("bwd_apply", (32, 512, 512), H100_SMEM, tfu.WORKSPACE),  # a half-plane beyond the limit
    ("bwd_apply", (12, 32, 32), H100_SMEM // 4, tfu.WORKSPACE),  # 2C not a multiple of 16
    ("forward", (12, 96, 96), H100_SMEM, tfu.WORKSPACE),  # 2C not a multiple of 16
    ("forward", (8, 108, 108), H100_SMEM, tfu.WORKSPACE),  # a dense plane beyond the limit
    # the statistics follow the backward apply's plan: per item at 32px,
    # staged at all four 128px maps and at 256 x 256, the workspace where
    # the stages do not go
    ("stats", (16, 16, 16), H100_SMEM, tfu.SHARED),
    ("stats", (8, 32, 32), H100_SMEM, tfu.SHARED),
    ("stats", (64, 16, 16), H100_SMEM, tfu.STAGED),
    ("stats", (32, 32, 32), H100_SMEM, tfu.STAGED),
    ("stats", (32, 64, 64), H100_SMEM, tfu.STAGED),
    ("stats", (32, 128, 128), H100_SMEM, tfu.STAGED),
    ("stats", (8, 96, 96), H100_SMEM, tfu.STAGED),
    ("stats", (32, 256, 256), H100_SMEM, tfu.STAGED),
    ("stats", (32, 512, 512), H100_SMEM, tfu.WORKSPACE),
])
def test_kernel_design_by_map(wrapper, cmap, limit, design):
    assert tfu.kernel_design(wrapper, *cmap, limit) == design


def test_item_plans_are_the_documented_sizes():
    """The per-item plans behind the rule: 213 KB for the forward at
    (64, 16, 16), above 227 KB for its backward."""
    assert tfu._item_floats(tfu._FWD, 64, 16, 16) * 4 == 218276
    assert tfu._item_floats(tfu._TRAIN, 64, 16, 16) * 4 > H100_SMEM
    assert tfu._item_floats(tfu._TRAIN, 8, 32, 32) * 4 < H100_SMEM


def test_split_plane_plan_is_the_documented_size():
    """The radix-2 plane path's shared memory a block takes
    (``_radix2_plane_floats``, csrc/fourier_unit_staged.cu's
    ``PlaneBufs``): a 256 x 256 plane's 266,240 B on one block exceeds the
    H100's 232,448 B, its half on each of two blocks takes 134,144 B, which
    ``_staged_smem`` reads there (the mix stages at 2C = 64 take 51,456 B);
    a 128 x 128 plane stays on one block (67,584 B)."""
    assert tfu._radix2_plane_floats(256, 256) * 4 == 266240 > H100_SMEM
    assert tfu._radix2_plane_floats(256, 256, 2) * 4 == 134144
    assert tfu._radix2_plane_floats(128, 128) * 4 == 67584
    assert tfu.plane_ranks(256, 256, H100_SMEM) == 2
    assert tfu.plane_ranks(128, 128, H100_SMEM) == 1
    assert tfu._staged_smem(32, 256, 256, H100_SMEM) == 134144
    assert tfu._staged_smem(32, 128, 128, H100_SMEM) == 67584
    assert tfu._staged_smem(32, 16, 16, H100_SMEM) == 51456


def test_kernel_design_at_the_edges_of_the_split_planes():
    """The split takes a power-of-two plane whose one-block buffers exceed
    the limit and whose half fits it: (32, 256, 256) staged at 134,144 B and
    not 1 B under it, on one block from 266,240 B; at the H100's limit 256
    x 256 is the largest plane it takes, and neither 256 x 512, 512 x 256
    nor 512 x 512 (266,240 B, 267,264 B and 530,432 B a half) fits, so those
    stay on the workspace. Dense planes and planes of H < 8 are never
    split; a tensor-parallel slice of (32, 256, 256) is split as the
    whole."""
    designs = lambda cmap, limit: [tfu.kernel_design(k, *cmap, limit)
                                   for k in ("forward", "bwd_apply", "stats")]
    assert designs((32, 256, 256), 134144) == ["staged"] * 3
    assert designs((32, 256, 256), 134144 - 1) == ["workspace"] * 3
    assert tfu.plane_ranks(256, 256, 266240 - 1) == 2
    assert tfu.plane_ranks(256, 256, 266240) == 1
    assert designs((32, 256, 256), 266240) == ["staged"] * 3
    for h, w, half in ((256, 512, 266240), (512, 256, 267264), (512, 512, 530432)):
        assert tfu._radix2_plane_floats(h, w, 2) * 4 == half > H100_SMEM
        assert designs((32, h, w), H100_SMEM) == ["workspace"] * 3
    assert tfu.plane_ranks(96, 96, 1) == 1
    assert tfu.plane_ranks(4, 64, 1) == 1 and tfu.plane_ranks(8, 64, 1) == 2
    # an out-channel slice (tensor parallelism) keeps the split planes
    for co in (16, 8):
        assert [tfu.kernel_design(k, 32, 256, 256, H100_SMEM, co)
                for k in ("forward", "bwd_apply", "stats")] == ["staged"] * 3


def _split_rfft2(x):
    """The forward of a split plane in f64, as the two ranks of
    csrc/fourier_unit_staged.cu compute it: each rank's half of the rows
    loaded, the a/d combine over the positions of the two halves (each
    rank taking half of the positions), the row rDFT, rank 1's rows times
    exp(-2 pi i h / H), the length-H/2 column transforms, and rank r's row q
    written as output row 2q + r; orthonormal, complex (B, C, H, Wf)."""
    b, c, h, w = x.shape
    rows = h // 2
    buf = [x[:, :, r * rows:(r + 1) * rows].clone() for r in (0, 1)]
    positions = rows * w  # the kernel's complex pairs are two of these
    flat = [t.reshape(b, c, positions) for t in buf]
    for rank in (0, 1):
        lo, hi = rank * (positions // 2), (rank + 1) * (positions // 2)
        v0, v1 = flat[0][..., lo:hi].clone(), flat[1][..., lo:hi].clone()
        flat[0][..., lo:hi], flat[1][..., lo:hi] = v0 + v1, v0 - v1
    twist = torch.exp(-2j * np.pi * torch.arange(rows, dtype=torch.float64) / h)[:, None]
    out = torch.empty(b, c, h, w // 2 + 1, dtype=torch.complex128)
    for rank in (0, 1):
        rdft = torch.fft.rfft(flat[rank].reshape(b, c, rows, w), dim=-1)
        out[:, :, rank::2] = torch.fft.fft(rdft * twist if rank else rdft, dim=-2)
    return out / np.sqrt(h * w)


def _split_irfft2(spec, w):
    """The inverse's split over H in f64 on a complex (B, C, H, Wf) spectrum:
    A = X[k] + X[k+H/2] on rank 0, B = (X[k] - X[k+H/2]) exp(+2 pi i k / H)
    on rank 1 (each rank taking half of the positions), length-H/2 inverse
    column transforms, rank r's row q as map row 2q + r; the row pass is
    ``torch.fft.irfft``'s, orthonormal."""
    b, c, h, wf = spec.shape
    rows = h // 2
    flat = [spec[:, :, r * rows:(r + 1) * rows].reshape(b, c, rows * wf).clone() for r in (0, 1)]
    row_of = torch.arange(rows * wf) // wf
    twist = torch.exp(2j * np.pi * row_of.double() / h)
    for rank in (0, 1):
        lo, hi = rank * (rows * wf // 2), (rank + 1) * (rows * wf // 2)
        v0, v1 = flat[0][..., lo:hi].clone(), flat[1][..., lo:hi].clone()
        flat[0][..., lo:hi], flat[1][..., lo:hi] = v0 + v1, (v0 - v1) * twist[lo:hi]
    y = torch.empty(b, c, h, w, dtype=torch.float64)
    for rank in (0, 1):
        cols = torch.fft.ifft(flat[rank].reshape(b, c, rows, wf), dim=-2, norm="forward")
        y[:, :, rank::2] = torch.fft.irfft(cols, n=w, dim=-1, norm="forward")
    return y / np.sqrt(h * w)


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (2, 3, 32, 64), (1, 2, 8, 4)])
def test_split_plane_arithmetic_matches_torch_fft(shape):
    """The split's combines, half-length transforms and row interleave,
    emulated in f64, give ``torch.fft.rfft2`` and ``irfft2`` (orthonormal)
    within 1e-12 rel-max; the exchange covers each position once (the two
    ranks' halves)."""
    x = torch.from_numpy(np.random.default_rng(50).normal(size=shape))
    want = torch.fft.rfft2(x, norm="ortho")
    got = _split_rfft2(x)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12
    y = _split_irfft2(want, shape[3])
    assert ((y - x).abs().max() / x.abs().max()).item() <= 1e-12
    assert (_split_irfft2(got, shape[3]) - torch.fft.irfft2(got, s=shape[2:], norm="ortho")
            ).abs().max().item() <= 1e-12 * x.abs().max().item()


def test_split_plane_size_plains_match_torch_fft():
    """At the split plane's size, (1, 2, 256, 256), ``fu_spectrum_plain`` is
    ``torch.fft.rfft2`` and ``fu_inverse_plain`` of the spectrum times the
    half-spectrum weights (1 at DC and Nyquist, 2 between: the inverse
    carries none) is ``irfft2``, orthonormal, in f64 within 1e-6 rel-max:
    the plain versions multiply by the JAX package's f32 factor matrices
    (``fourier.forward_factors``), whose rounding leaves about 3e-8 here,
    and nothing else."""
    x = torch.from_numpy(np.random.default_rng(51).normal(size=(1, 2, 256, 256)))
    spec = tfu.fu_spectrum_plain(x)[0]
    want = torch.fft.rfft2(x, norm="ortho")
    got = torch.complex(spec[:, :2], spec[:, 2:])
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
    y = tfu.fu_inverse_plain(torch.cat([want.real, want.imag], 1) * tfu._half_weights(spec),
                             torch.float64, 256)
    assert ((y - x).abs().max() / x.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("b,h,w,chunks", [
    (64, 128, 128, 8), (64, 64, 64, 8), (64, 32, 32, 8), (64, 16, 16, 3),
    (2, 128, 128, 130), (8, 64, 64, 33), (1024, 128, 128, 1),
    # 96 x 96: 74 tiles (the last half full); at batch 8, 64 runs of 2 tiles,
    # of which 37 hold tiles (the others write zero partial rows)
    (8, 96, 96, 64), (64, 96, 96, 8),
    # 256 x 256: 516 tiles, 8 runs of 65 at batch 64 (the last of 61)
    (64, 256, 256, 8), (8, 256, 256, 64),
])
def test_staged_chunks_fill_the_card_with_whole_tiles(b, h, w, chunks):
    """Runs of 64-position tiles per item: 512 blocks over the batch, at
    most one tile each."""
    assert tfu.staged_chunks(b, h, w) == chunks


def _stage_forward(x, kernel, scale, bias, mean, var):
    z = tfu.fu_spectrum_plain(x)[0]
    r = tfu.fu_mix_apply_plain(z, kernel, scale, bias, mean, var)
    return tfu.fu_inverse_plain(r, x.dtype, x.shape[3])


def _stage_bwd_apply(x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias):
    z, g = tfu.fu_spectrum_plain(x, gy)
    gz, gk = tfu.fu_bwd_mix_plain(z, g, kernel, scale, bias, bmean, bvar, gscale, gbias)
    return tfu.fu_inverse_plain(gz, x.dtype, x.shape[3]), gk


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_stage_plains_compose_to_the_plain_forward_and_backward(shape):
    """In f64 the stages, composed as the wrappers compose the kernels,
    give the per-item plain versions to 1e-12 rel-max."""
    x, kernel, scale, bias, gy = (t.double() for t in _port(*_train_inputs(shape, seed=8)))
    bmean, bvar = tfu.fu_train_stats_plain(x, kernel)
    y = tfu.fourier_unit_forward_plain(x, kernel, scale, bias, bmean, bvar)
    assert _rel_max(_stage_forward(x, kernel, scale, bias, bmean, bvar), y) <= 1e-12
    gscale, gbias = tfu.fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)
    args = (x, kernel, scale, bias, bmean, bvar, gy, gscale, gbias)
    for a, b in zip(_stage_bwd_apply(*args), tfu.fu_bwd_apply_plain(*args)):
        assert _rel_max(a, b) <= 1e-12


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_spectrum_plain_matches_jax_rfft2(shape):
    """fu_spectrum_plain of two maps against the JAX package's rfft2_ortho
    of each (factor form), f32: 1e-5 absolute on O(1) values."""
    inputs = _train_inputs(shape, seed=9)
    x, gy = inputs[0], inputs[-1]
    xt, *_, gyt = _port(*inputs)
    spec = tfu.fu_spectrum_plain(xt, gyt)
    c = shape[3]
    for i, m in enumerate((x, gy)):
        f_r, f_i = jfourier.rfft2_ortho(jnp.asarray(m), impl="dft")
        np.testing.assert_allclose(_nhwc(spec[i, :, :c]), np.asarray(f_r), atol=1e-5)
        np.testing.assert_allclose(_nhwc(spec[i, :, c:]), np.asarray(f_i), atol=1e-5)


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_inverse_plain_matches_jax_forward_adjoint(shape):
    """fu_inverse_plain (no half-spectrum weights, what the dense inverse
    computes) of a seeded spectrum against the JAX FourierUnit's
    ``_dft_forward_adjoint`` on the same factor tables, f32: 1e-5
    absolute."""
    b, h, w, c = shape
    rng = np.random.default_rng(17)
    g_r, g_i = (rng.normal(size=(b, h, w // 2 + 1, c)).astype(np.float32) for _ in range(2))
    ah, bh, cw, dw = jfu._factors(h, w, jnp.float32)[:4]
    want = jfu._dft_forward_adjoint(jnp.asarray(g_r), jnp.asarray(g_i), ah, bh, cw, dw,
                                    jax.lax.Precision.HIGHEST)
    spec = torch.from_numpy(np.concatenate([g_r, g_i], axis=3)).permute(0, 3, 1, 2).contiguous()
    np.testing.assert_allclose(_nhwc(tfu.fu_inverse_plain(spec, torch.float32, w)),
                               np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_stage_plains_match_jax_spec_forward(shape):
    """The staged forward with the batch statistics against the JAX
    FourierUnit's ``_spec_forward`` in train mode, f32: 1e-5 absolute."""
    x, kernel, scale, bias, _ = _train_inputs(shape, seed=10)
    c2 = kernel.shape[0]
    y_j, m_j, v_j = jfu._spec_forward(
        *(jnp.asarray(a) for a in (x, kernel, scale, bias)), jnp.zeros(c2), jnp.ones(c2), True)
    xt, kt, st, bt = _port(x, kernel, scale, bias)
    y_t = _stage_forward(xt, kt, st, bt, torch.from_numpy(np.array(m_j)),
                         torch.from_numpy(np.array(v_j)))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_stage_plains_match_jax_custom_vjp(shape):
    """The staged backward apply (with the backward sums of the plain
    version) against jax.vjp of the JAX FourierUnit in train mode, f32:
    gx and gK to 1e-4 rel-max, the bar of the per-item backward's test."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=11)
    xt, kt, st, bt, gyt = _port(x, kernel, scale, bias, gy)
    bmean, bvar = tfu.fu_train_stats_plain(xt, kt)
    gscale, gbias = tfu.fu_bwd_stats_plain(xt, kt, st, bt, bmean, bvar, gyt)
    gx, gk = _stage_bwd_apply(xt, kt, st, bt, bmean, bvar, gyt, gscale, gbias)
    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias)) + (
        jnp.asarray(bmean.numpy()), jnp.asarray(bvar.numpy()))
    (_, m_j, v_j), vjp = jax.vjp(lambda *a: jfu.fourier_unit_fused(*a, True), *args)
    gx_j, gk_j = vjp((jnp.asarray(gy), jnp.zeros_like(m_j), jnp.zeros_like(v_j)))[:2]
    assert _rel_max(_nhwc(gx), gx_j) <= 1e-4
    assert _rel_max(gk.numpy(), gk_j) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_statistics_stage_plains_compose_to_the_plain_statistics(shape):
    """In f64 the statistics stages, composed as ``fu_train_stats`` and
    ``fu_bwd_stats`` compose the kernels on a staged map (one spectrum,
    then the stage), give the per-item plain versions to 1e-12 rel-max."""
    x, kernel, scale, bias, gy = (t.double() for t in _port(*_train_inputs(shape, seed=14)))
    stats = tfu.fu_mix_stats_plain(tfu.fu_spectrum_plain(x)[0], kernel)
    want = tfu.fu_train_stats_plain(x, kernel)
    for a, b in zip(stats, want):
        assert _rel_max(a, b) <= 1e-12
    bmean, bvar = want
    z, g = tfu.fu_spectrum_plain(x, gy)
    sums = tfu.fu_bwd_stats_mix_plain(z, g, kernel, scale, bias, bmean, bvar)
    for a, b in zip(sums, tfu.fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)):
        assert _rel_max(a, b) <= 1e-12


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_staged_training_forward_matches_jax_spec_forward(shape):
    """``_train_forward_staged`` on CPU tensors (the stage wrappers' plain
    versions, one spectrum) against the JAX FourierUnit's ``_spec_forward``
    in train mode, f32: y and the batch statistics to 1e-5 absolute, the
    bar of the per-item plain train forward's test."""
    x, kernel, scale, bias, _ = _train_inputs(shape, seed=15)
    c2 = kernel.shape[0]
    y_j, m_j, v_j = jfu._spec_forward(
        *(jnp.asarray(a) for a in (x, kernel, scale, bias)), jnp.zeros(c2), jnp.ones(c2), True)
    y_t, m_t, v_t = tfu._train_forward_staged(*_port(x, kernel, scale, bias))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES + DENSE_SHAPES)
def test_staged_training_backward_matches_jax_custom_vjp(shape):
    """``_train_backward_staged`` on CPU tensors (one two-map spectrum, the
    backward sums, then the backward apply's mix and inverse) with the
    statistics of ``_train_forward_staged``, against jax.vjp of the JAX
    FourierUnit in train mode, f32: gx, gK, gscale and gbias to 1e-4
    rel-max, the bar of the per-item backward's test."""
    x, kernel, scale, bias, gy = _train_inputs(shape, seed=16)
    xt, kt, st, bt, gyt = _port(x, kernel, scale, bias, gy)
    _, bmean, bvar = tfu._train_forward_staged(xt, kt, st, bt)
    ours = tfu._train_backward_staged(xt, kt, st, bt, bmean, bvar, gyt)
    args = tuple(jnp.asarray(a) for a in (x, kernel, scale, bias)) + (
        jnp.asarray(bmean.numpy()), jnp.asarray(bvar.numpy()))
    (_, m_j, v_j), vjp = jax.vjp(lambda *a: jfu.fourier_unit_fused(*a, True), *args)
    theirs = vjp((jnp.asarray(gy), jnp.zeros_like(m_j), jnp.zeros_like(v_j)))
    ours = (_nhwc(ours[0]), *(t.numpy() for t in ours[1:]))
    for name, a, b in zip(("gx", "gK", "gscale", "gbias"), ours, theirs):
        assert _rel_max(a, b) <= 1e-4, (name, _rel_max(a, b))


def test_stage_wrappers_route_cpu_tensors_to_plain_without_launching():
    x, kernel, scale, bias, gy = _port(*_train_inputs((2, 16, 16, 8), seed=12))
    bmean, bvar = tfu.fu_train_stats_plain(x, kernel)
    gscale, gbias = tfu.fu_bwd_stats_plain(x, kernel, scale, bias, bmean, bvar, gy)
    before = [(f.launches, sum(f.launches_by_map.values())) for f in STAGE_WRAPPERS]
    spec = tfu.fu_spectrum(x, gy)
    assert torch.equal(spec, tfu.fu_spectrum_plain(x, gy))
    z, g = spec
    r = tfu.fu_mix_apply(z, kernel, scale, bias, bmean, bvar)
    assert torch.equal(r, tfu.fu_mix_apply_plain(z, kernel, scale, bias, bmean, bvar))
    assert torch.equal(tfu.fu_inverse(r, x.dtype, 16), tfu.fu_inverse_plain(r, x.dtype, 16))
    mix = (kernel, scale, bias, bmean, bvar, gscale, gbias)
    for a, b in zip(tfu.fu_bwd_mix(z, g, *mix), tfu.fu_bwd_mix_plain(z, g, *mix)):
        assert torch.equal(a, b)
    for a, b in zip(tfu.fu_mix_stats(z, kernel), tfu.fu_mix_stats_plain(z, kernel)):
        assert torch.equal(a, b)
    for a, b in zip(tfu.fu_bwd_stats_mix(z, g, *mix[:5]), tfu.fu_bwd_stats_mix_plain(z, g, *mix[:5])):
        assert torch.equal(a, b)
    assert [(f.launches, sum(f.launches_by_map.values())) for f in STAGE_WRAPPERS] == before


def test_stage_wrappers_reject_malformed_operands():
    x, kernel, scale, bias, gy = _port(*_train_inputs((2, 8, 8, 4), seed=13))
    z = tfu.fu_spectrum(x)[0]
    with pytest.raises(ValueError, match="one or two maps"):
        tfu.fu_spectrum(x, gy[:1])
    with pytest.raises(ValueError, match="float32"):
        tfu.fu_mix_apply(z.double(), kernel, scale, bias, scale, scale)
    with pytest.raises(ValueError, match="kernel"):
        tfu.fu_mix_apply(z, kernel[:4, :4], scale, bias, scale, scale)
    with pytest.raises(ValueError, match="var"):
        tfu.fu_mix_apply(z, kernel, scale, bias, scale, scale[:3])
    with pytest.raises(ValueError, match="width"):
        tfu.fu_inverse(z, torch.float32, 10)
    with pytest.raises(ValueError, match="share one shape"):
        tfu.fu_bwd_mix(z, z[:1], kernel, scale, bias, scale, scale, scale, scale)
    with pytest.raises(ValueError, match="kernel"):
        tfu.fu_mix_stats(z, kernel.double())
    with pytest.raises(ValueError, match="share one shape"):
        tfu.fu_bwd_stats_mix(z, z[:, :2], kernel, scale, bias, scale, scale)
    with pytest.raises(ValueError, match="bvar"):
        tfu.fu_bwd_stats_mix(z, z, kernel, scale, bias, scale, scale[:3])
