"""The port's CUDA kernel against its plain version, on the card.

Marked ``gpu``; each test skips when CUDA is absent. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from fastfourierconvolution_tpu_torch import Generator
from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
    fourier_unit_forward,
    fourier_unit_forward_plain,
)

pytestmark = pytest.mark.gpu

# The generator's FourierUnit maps at serving batch 64, (B, C, H, W).
SLICE_SHAPES = [(64, 16, 16, 16), (64, 8, 32, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _inputs(shape, dtype, device, seed=0):
    b, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    kernel = torch.randn(2 * c, 2 * c, generator=g) * 0.2
    scale = torch.randn(2 * c, generator=g).abs() + 0.5
    bias = torch.randn(2 * c, generator=g) * 0.1
    mean = torch.randn(2 * c, generator=g) * 0.1
    var = torch.randn(2 * c, generator=g).abs() + 0.5
    return (x.to(device, dtype), kernel.to(device, dtype),
            *(t.to(device) for t in (scale, bias, mean, var)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", SLICE_SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    """rel-max = max|y - y_plain| / max|y_plain|: 1e-4 in f32 (TF32 off),
    2e-2 in bf16 (the kernel keeps f32 where the plain version rounds to
    bf16 after each stage)."""
    args = _inputs(shape, dtype, cuda)
    before = fourier_unit_forward.launches
    y = fourier_unit_forward(*args)
    torch.cuda.synchronize()
    assert fourier_unit_forward.launches == before + 1
    ref = fourier_unit_forward_plain(*args).float()
    assert y.shape == ref.shape and y.dtype == dtype
    rel = ((y.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= tol, rel


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, kernel, scale, bias, mean, var = _inputs((2, 8, 16, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fourier_unit_forward(x.transpose(2, 3), kernel, scale, bias, mean, var)
    with pytest.raises(ValueError, match="one device"):
        fourier_unit_forward(x, kernel.cpu(), scale, bias, mean, var)
    big = _inputs((1, 64, 128, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fourier_unit_forward(*big)


def test_served_request_launches_the_kernel_twice(cuda):
    server = Generator.from_preset(32, device=cuda)
    z = torch.randn(5, 128, generator=torch.Generator().manual_seed(1))
    before = fourier_unit_forward.launches
    images = server.generate(z)
    torch.cuda.synchronize()
    assert images.shape == (5, 32, 32, 3) and images.dtype == torch.uint8
    assert fourier_unit_forward.launches == before + 2
