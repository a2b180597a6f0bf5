"""The port's Fourier ops and FourierUnit op against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages: NHWC
to JAX, NCHW to the port. Everything runs in f32, where the point is the
algorithm; the tolerances are stated per test.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.ops import fourier as jfourier
from fastfourierconvolution_tpu.ops.pallas import fourier_unit as jfu
from fastfourierconvolution_tpu_torch.ops import fourier as tfourier
from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
    fourier_unit_forward,
    fourier_unit_forward_plain,
)

SHAPES = [(4, 8, 8, 6), (2, 16, 16, 8)]  # (B, H, W, C)


def _fu_inputs(shape, seed=0):
    """x (NHWC), kernel, scale, bias, running mean, running var as numpy f32."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (
        f32(rng.normal(size=(b, h, w, c))),
        f32(rng.normal(size=(2 * c, 2 * c)) * 0.2),
        f32(np.abs(rng.normal(size=2 * c)) + 0.5),
        f32(rng.normal(size=2 * c) * 0.1),
        f32(rng.normal(size=2 * c) * 0.1),
        f32(np.abs(rng.normal(size=2 * c)) + 0.5),
    )


def _port_args(args):
    x, *rest = args
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            *(torch.from_numpy(a) for a in rest))


def _port_y_nhwc(args):
    y = fourier_unit_forward_plain(*_port_args(args))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_spec_forward(shape):
    """Same math, both in full f32: agreement to 1e-5 absolute on O(1) y."""
    args = _fu_inputs(shape)
    y_j, _, _ = jfu._spec_forward(*(jnp.asarray(a) for a in args), False)
    np.testing.assert_allclose(_port_y_nhwc(args), np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("mode", ["sep", "kron"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_apply_interpret(shape, mode):
    """The port's plain op against the Pallas apply kernel it replaces, run
    in interpret mode. 2e-5 absolute: the Pallas kernel sums in another
    order (the bar the JAX package holds it to against _spec_forward)."""
    args = _fu_inputs(shape, seed=1)
    y_p, _, _ = jfu._pallas_forward(
        *(jnp.asarray(a) for a in args), False, interpret=True, mode=mode
    )
    np.testing.assert_allclose(_port_y_nhwc(args), np.asarray(y_p), atol=2e-5)


@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("hw", [(8, 8), (16, 16), (8, 6), (6, 5)])
def test_factor_transforms_match_jax(hw, impl):
    """Forward and inverse (on a non-Hermitian spectrum) agree with both JAX
    implementations to 1e-5 absolute."""
    h, w = hw
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    wf = w // 2 + 1
    g_r = rng.normal(size=(2, h, wf, 3)).astype(np.float32)
    g_i = rng.normal(size=(2, h, wf, 3)).astype(np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()

    jf_r, jf_i = jfourier.rfft2_ortho(jnp.asarray(x), impl=impl)
    tf_r, tf_i = tfourier.rfft2_ortho(nchw(x))
    np.testing.assert_allclose(nhwc(tf_r), np.asarray(jf_r), atol=1e-5)
    np.testing.assert_allclose(nhwc(tf_i), np.asarray(jf_i), atol=1e-5)

    jy = jfourier.irfft2_ortho(jnp.asarray(g_r), jnp.asarray(g_i), (h, w), impl=impl)
    ty = tfourier.irfft2_ortho(nchw(g_r), nchw(g_i), (h, w))
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), atol=1e-5)


def test_fft_forms_match_factor_forms_on_cpu():
    """On the CPU torch.fft (pocketfft) agrees with the factor definition,
    also for a non-Hermitian spectrum; 1e-5 absolute."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16, 16)).astype(np.float32))
    for a, b in zip(tfourier.rfft2_ortho_fft(x), tfourier.rfft2_ortho(x)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    g_r, g_i = (torch.from_numpy(rng.normal(size=(2, 3, 16, 9)).astype(np.float32))
                for _ in range(2))
    torch.testing.assert_close(
        tfourier.irfft2_ortho_fft(g_r, g_i, (16, 16)),
        tfourier.irfft2_ortho(g_r, g_i, (16, 16)), atol=1e-5, rtol=0,
    )


def test_factor_matrices_match_jax():
    for h, w in [(16, 16), (32, 32), (8, 6)]:
        for mine, theirs in zip(
            tfourier.forward_factors(h, w) + tfourier.inverse_factors(h, w),
            jfourier._forward_factors(h, w) + jfourier._inverse_factors(h, w),
        ):
            np.testing.assert_array_equal(mine, theirs)


def test_wrapper_routes_cpu_tensors_to_plain_without_launching():
    args = _port_args(_fu_inputs((2, 16, 16, 8), seed=4))
    before = fourier_unit_forward.launches
    y = fourier_unit_forward(*args)
    assert torch.equal(y, fourier_unit_forward_plain(*args))
    assert fourier_unit_forward.launches == before


def test_wrapper_rejects_malformed_operands():
    x, kernel, scale, bias, mean, var = _port_args(_fu_inputs((2, 8, 8, 4)))
    with pytest.raises(ValueError, match="kernel"):
        fourier_unit_forward(x, kernel.double(), scale, bias, mean, var)
    with pytest.raises(ValueError, match="kernel"):
        fourier_unit_forward(x, kernel[:4, :4], scale, bias, mean, var)
    with pytest.raises(ValueError, match="var"):
        fourier_unit_forward(x, kernel, scale, bias, mean, var[:3])
    with pytest.raises(ValueError, match="B, C, H, W"):
        fourier_unit_forward(x[0], kernel, scale, bias, mean, var)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fourier_unit_forward(x.half(), kernel.half(), scale, bias, mean, var)
