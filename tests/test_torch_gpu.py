"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips when CUDA is absent. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from fastfourierconvolution_tpu_torch import (
    FFCGenerator,
    GANTrainer,
    Generator,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu
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


def _train_case(name, shape, dtype, device):
    """(kernel wrapper, plain version, arguments) for a training kernel at
    ``shape``; the backward's statistics come from the plain version in
    f64, rounded to f32."""
    x, kernel, scale, bias, _, _ = _inputs(shape, dtype, device)
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(device, dtype)
    mean, var = (t.float() for t in fu.fu_train_stats_plain(x.double(), kernel.double()))
    if name == "fu_train_stats":
        return fu.fu_train_stats, fu.fu_train_stats_plain, (x, kernel)
    args = (x, kernel, scale, bias, mean, var, gy)
    if name == "fu_bwd_stats":
        return fu.fu_bwd_stats, fu.fu_bwd_stats_plain, args
    gscale, gbias = (t.float() for t in fu.fu_bwd_stats_plain(*(a.double() for a in args)))
    return fu.fu_bwd_apply, fu.fu_bwd_apply_plain, args + (gscale, gbias)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", SLICE_SHAPES)
@pytest.mark.parametrize("name", ["fu_train_stats", "fu_bwd_stats", "fu_bwd_apply"])
def test_training_kernel_matches_plain(cuda, name, shape, dtype, tol):
    """Every output, rel-max against the plain version evaluated in f32 on
    the same inputs: 1e-4 in f32 (TF32 off); 2e-2 in bf16, where the
    kernels compute in f32 and the plain version run in bf16 is itself up
    to 7e-2 from the f32 result (it rounds every stage to bf16, and the
    backward's sums cancel)."""
    kernel, plain, args = _train_case(name, shape, dtype, cuda)
    before = (kernel.launches, fu.fu_reduce.launches)
    outs = kernel(*args)
    torch.cuda.synchronize()
    assert (kernel.launches, fu.fu_reduce.launches) == (before[0] + 1, before[1] + 1)
    refs = plain(*(a.double() for a in args))
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= tol, rel


def test_training_kernels_give_the_same_bits_every_launch(cuda):
    """The batch sums are reduced in a fixed order: no run-to-run jitter."""
    kernel, _, args = _train_case("fu_bwd_apply", SLICE_SHAPES[0], torch.float32, cuda)
    first = kernel(*args)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(kernel(*args), first))


def test_training_step_launches_each_kernel_a_fixed_number_of_times(cuda):
    """Per step and FourierUnit map: stats 2 (G phase and D phase
    forwards), forward 2, backward stats 1, backward apply 1, and 4 batch
    reductions (two of the stats, one per backward kernel)."""
    trainer = GANTrainer(FFCGenerator.for_resolution(32), SNConvDiscriminator.for_resolution(32),
                         device=cuda)
    real = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    wrappers = (fu.fu_train_stats, fu.fourier_unit_forward, fu.fu_bwd_stats, fu.fu_bwd_apply)
    maps = [(16, 16, 16), (8, 32, 32)]
    for _ in range(2):
        before = [dict(f.launches_by_map) for f in wrappers] + [fu.fu_reduce.launches]
        losses = trainer.update_step(real)
        torch.cuda.synchronize()
        assert all(torch.isfinite(v) for v in losses.values())
        for f, was, want in zip(wrappers, before, (2, 2, 1, 1)):
            assert {m: f.launches_by_map[m] - was.get(m, 0) for m in maps} == dict.fromkeys(maps, want)
        assert fu.fu_reduce.launches - before[-1] == 4 * len(maps)
