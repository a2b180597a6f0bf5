"""The port's CUDA kernels against their plain versions, and the training
step as a CUDA graph (``update_steps``) against eager steps, on the card.

Marked ``gpu``; each test skips when CUDA is absent. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import os

import pytest
import torch

from fastfourierconvolution_tpu_torch import (
    CondDCGANDiscriminator,
    CondDCGANGenerator,
    CondSNDiscriminator,
    FFCCondGenerator,
    FFCDiscriminator,
    FFCGenerator,
    GANTrainer,
    Generator,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.ops import bn_act as ba
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu
from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
    fourier_unit_forward,
    fourier_unit_forward_plain,
)
from fastfourierconvolution_tpu_torch.train.gan import LOSS_PAIRS

pytestmark = pytest.mark.gpu

# cuBLAS reads this when it first starts, before any test runs a product;
# the graph-parity tests run under deterministic algorithms, which need it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    # no pre-activation within rounding of the ReLU's kink, where the
    # backward jumps (see relu_margin_bias)
    bias, _ = fu.relu_margin_bias(x, kernel, scale, bias, mean, var)
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
                         fused_dis_batch=True, device=cuda)
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


# A FourierUnit map of the 128px generator (block3's), whose buffers exceed
# a block's shared memory.
LARGE_SHAPE = (4, 32, 64, 64)
# A map of the 96px generator's shape class that the staged kernels do not
# take (96 is no power of two): the per-item kernels keep its buffers in a
# per-item workspace.
WORKSPACE_SHAPE = (2, 8, 96, 96)


# The kernel whose launch each wrapper's call makes at LARGE_SHAPE: every
# wrapper runs as the staged kernels there (counted by its mix stage).
LARGE_SHAPE_LAUNCHES = {"fourier_unit_fwd": "fu_mix_apply", "fu_train_stats": "fu_mix_stats",
                        "fu_bwd_stats": "fu_bwd_stats_mix", "fu_bwd_apply": "fu_bwd_mix"}


def _check_large_map(cuda, name, shape, counted):
    """``name``'s wrapper at ``shape`` in f32 (TF32 off): ``counted``
    launches once, every output within 1e-4 rel-max of the plain version
    in f64."""
    if name == "fourier_unit_fwd":
        args = _inputs(shape, torch.float32, cuda)
        kernel, plain = fourier_unit_forward, fourier_unit_forward_plain
    else:
        kernel, plain, args = _train_case(name, shape, torch.float32, cuda)
    before = counted.launches_by_map[shape[1:]]
    outs = kernel(*args)
    torch.cuda.synchronize()
    assert counted.launches_by_map[shape[1:]] == before + 1
    refs = plain(*(a.double() for a in args))
    for out, ref in zip(*((outs, refs) if isinstance(outs, tuple) else ((outs,), (refs,)))):
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("name", ["fourier_unit_fwd", "fu_train_stats", "fu_bwd_stats",
                                  "fu_bwd_apply"])
def test_large_map_kernels_match_plain(cuda, name):
    """f32 (TF32 off), every output within 1e-4 rel-max of the plain
    version in f64; every wrapper as the staged kernels, where the per-item
    plan of the training kernels would need the workspace."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert fu._item_floats(fu._TRAIN, *LARGE_SHAPE[1:]) * 4 > limit
    _check_large_map(cuda, name, LARGE_SHAPE, getattr(fu, LARGE_SHAPE_LAUNCHES[name]))


@pytest.mark.parametrize("name", ["fu_train_stats", "fu_bwd_stats"])
def test_workspace_statistics_kernels_match_plain(cuda, name):
    """The statistics kernels in the per-item workspace layout, on a map
    that the staged kernels do not take: their own kernel launches, every
    output within 1e-4 rel-max of the plain version in f64."""
    assert fu._design("stats", torch.empty(WORKSPACE_SHAPE, device=cuda)) == fu.WORKSPACE
    _check_large_map(cuda, name, WORKSPACE_SHAPE, getattr(fu, name))


@pytest.mark.parametrize("name,design", [("fourier_unit_fwd", "forward"),
                                         ("fu_bwd_apply", "bwd_apply")])
def test_workspace_forward_and_backward_apply_match_plain(cuda, name, design):
    """The forward and the backward apply in the per-item workspace
    layout, where no cluster's per-rank plan fits either: their own kernel
    launches, every output within 1e-4 rel-max of the plain version in
    f64."""
    assert fu._design(design, torch.empty(WORKSPACE_SHAPE, device=cuda)) == fu.WORKSPACE
    counted = fu.fourier_unit_forward if name == "fourier_unit_fwd" else fu.fu_bwd_apply
    _check_large_map(cuda, name, WORKSPACE_SHAPE, counted)


# A packed map of the 128px generator's shape class (block1's widths, batch 8).
PACKED_SHAPE = (8, 256, 16, 16)


def _bn_args(dtype, device, noise):
    b, c, h, w = PACKED_SHAPE
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(PACKED_SHAPE, generator=g) * 1.5 + 0.3).to(device, dtype)
    gy = torch.randn(PACKED_SHAPE, generator=g).to(device, dtype)
    n_l, n_g = (torch.randn(b, 1, h, w, generator=g).to(device, dtype) for _ in range(2))
    scale, bias, wn, g_mean, g_var = (torch.randn(c, generator=g).to(device) for _ in range(5))
    mean, var = (t.float() for t in ba.bn_stats_plain(x.double()))
    cl = c // 2
    s1, s2 = (t.float() for t in ba.bn_bwd_reduce_plain(x, gy, mean, var, scale, bias,
                                                         sum_dtype=torch.float64)[:2])
    return {
        "bn_stats": (x,),
        "bn_gelu_apply": (x, mean, var, scale, bias) + ((wn, n_l, n_g, cl) if noise else ()),
        "bn_bwd_reduce": (x, gy, mean, var, scale, bias) + ((n_l, n_g, cl) if noise else ()),
        "bn_bwd_dx": (x, gy, mean, var, scale, bias, s1, s2, g_mean, g_var)
        + ((wn, cl) if noise else ()),
    }


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["bn_stats", "bn_gelu_apply", "bn_bwd_reduce", "bn_bwd_dx"])
def test_bn_act_kernels_match_plain(cuda, name, dtype, noise):
    """Every output against the plain version on the same inputs: rel-max
    1e-5 (f32 maps and every sum; the sums take du in f32 either way);
    bf16 maps within 2 bf16 ulps at their magnitude (both round once from
    f32). Two launches give the same bits."""
    args = _bn_args(dtype, cuda, noise)[name]
    wrapper, plain = getattr(ba, name), getattr(ba, name + "_plain")
    before = wrapper.launches
    outs = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = plain(*args)
    refs = refs if isinstance(refs, tuple) else (refs,)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        err = (out.float() - ref.float()).abs().max().item()
        if out.dtype == torch.bfloat16:
            ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())).item() - 7)
            assert err <= 2 * ulp, err / ulp
        else:
            assert err <= 1e-5 * ref.abs().max().item(), err
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


def test_packed_128px_training_step_runs_the_fused_and_large_map_kernels(cuda):
    """A 128px packed step at batch 2: every packed block through the fused
    BN + GELU kernels with the noise fold, every FourierUnit map through
    the large-map kernels (staged or workspace layout); losses finite."""
    trainer = GANTrainer(FFCGenerator.for_resolution(128), SNConvDiscriminator.for_resolution(128),
                         fused_dis_batch=True, device=cuda)
    real = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    wrappers = (ba.bn_stats, ba.bn_gelu_apply, ba.bn_bwd_reduce, ba.bn_bwd_dx,
                fu.fu_train_stats, fu.fourier_unit_forward, fu.fu_bwd_stats, fu.fu_bwd_apply,
                fu.fu_spectrum, fu.fu_mix_stats, fu.fu_mix_apply, fu.fu_inverse,
                fu.fu_bwd_stats_mix, fu.fu_bwd_mix)
    before = [w.launches for w in wrappers]
    losses = trainer.update_step(real)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in losses.values())
    # five packed blocks, four FourierUnit maps; (G phase + D phase) forwards,
    # one backward. The statistics are staged at all four maps, so the
    # training op runs the stages: per map and forward one spectrum, the
    # statistics stage, the apply stage and the inverse; per map and
    # backward one two-map spectrum, both backward stages and the inverse.
    want = (10, 10, 5, 5, 0, 0, 0, 0, 4 * 3, 4 * 2, 4 * 2, 4 * 3, 4, 4)
    assert tuple(w.launches - b for w, b in zip(wrappers, before)) == want


# Maps that the staged kernels take, at batch 2: the 128px generator's
# two largest and the 64px generator's largest (2C = 16).
STAGED_SHAPES = [(2, 32, 128, 128), (2, 32, 64, 64), (2, 8, 64, 64)]
# Each stage at every width it is built for: 2C = 64, 16, 32 and 128.
STAGE_SHAPES = STAGED_SHAPES[1:] + [(2, 16, 32, 32), (2, 64, 16, 16)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", STAGED_SHAPES)
@pytest.mark.parametrize("name", ["fourier_unit_fwd", "fu_bwd_apply"])
def test_staged_kernels_match_plain(cuda, name, shape, dtype, tol):
    """The staged forward and backward apply against their plain versions
    in f64 (the backward with ``relu_margin_bias``), every output within
    rel-max 1e-4 in f32 and 2e-2 in bf16; each stage launches once; two
    launches give the same bits."""
    if name == "fourier_unit_fwd":
        args = _inputs(shape, dtype, cuda)
        wrapper, plain = fourier_unit_forward, fourier_unit_forward_plain
        stages = {fu.fu_spectrum: 1, fu.fu_mix_apply: 1, fu.fu_inverse: 1}
    else:
        wrapper, plain, args = _train_case(name, shape, dtype, cuda)
        stages = {fu.fu_spectrum: 1, fu.fu_bwd_mix: 1, fu.fu_inverse: 1, fu.fu_reduce: 1}
    before = {f: f.launches for f in stages}
    own = wrapper.launches
    outs = wrapper(*args)
    torch.cuda.synchronize()
    assert {f: f.launches - before[f] for f in stages} == stages
    assert wrapper.launches == own
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = plain(*(a.double() for a in args))
    refs = refs if isinstance(refs, tuple) else (refs,)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= tol, rel
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


@pytest.mark.parametrize("shape", STAGE_SHAPES)
@pytest.mark.parametrize("name", ["fu_spectrum", "fu_mix_apply", "fu_inverse", "fu_bwd_mix",
                                  "fu_mix_stats", "fu_bwd_stats_mix"])
def test_staged_stages_match_plain(cuda, name, shape):
    """Each stage kernel against its plain version in f64 on the same f32
    inputs, 1e-4 rel-max on every output; two launches give the same bits
    (``fu_bwd_mix`` writes gz over its G, so each of its calls takes a
    fresh copy)."""
    x, kernel, scale, bias, mean, var, gy = _train_case("fu_bwd_stats", shape, torch.float32,
                                                        cuda)[2]
    gscale, gbias = (t.float() for t in fu.fu_bwd_stats_plain(
        *(a.double() for a in (x, kernel, scale, bias, mean, var, gy))))
    z, g = fu.fu_spectrum(x, gy)
    w = shape[3]
    cases = {
        "fu_spectrum": (fu.fu_spectrum, fu.fu_spectrum_plain, (x, gy)),
        "fu_mix_apply": (fu.fu_mix_apply, fu.fu_mix_apply_plain, (z, kernel, scale, bias, mean, var)),
        "fu_inverse": (lambda s: fu.fu_inverse(s, torch.float32, w),
                       lambda s: fu.fu_inverse_plain(s, torch.float64, w), (g,)),
        "fu_bwd_mix": (lambda z_, g_, *rest: fu.fu_bwd_mix(z_, g_.clone(), *rest),
                       fu.fu_bwd_mix_plain, (z, g, kernel, scale, bias, mean, var, gscale, gbias)),
        "fu_mix_stats": (fu.fu_mix_stats, fu.fu_mix_stats_plain, (z, kernel)),
        "fu_bwd_stats_mix": (fu.fu_bwd_stats_mix, fu.fu_bwd_stats_mix_plain,
                             (z, g, kernel, scale, bias, mean, var)),
    }
    wrapper, plain, args = cases[name]
    refs = plain(*(a.double() for a in args))
    outs = wrapper(*args)
    torch.cuda.synchronize()
    outs, refs = (outs, refs) if isinstance(outs, tuple) else ((outs,), (refs,))
    for out, ref in zip(outs, refs):
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, rel
    again = wrapper(*args)
    assert all(torch.equal(a, b) for a, b in zip(outs, again if isinstance(again, tuple) else (again,)))


# The 128px generator's four FourierUnit maps at batch 2.
FU128_MAPS = [(2, 64, 16, 16), (2, 32, 32, 32), (2, 32, 64, 64), (2, 32, 128, 128)]


@pytest.mark.parametrize("shape", FU128_MAPS)
def test_staged_training_op_matches_plain(cuda, shape):
    """The training op on a map whose statistics run staged, f32 (TF32
    off): y, bmean and bvar, and the gradients of x, kernel, scale and bias
    (with ``relu_margin_bias``), within 1e-4 rel-max of the plain op in
    f64. One spectrum per forward and one two-map spectrum per backward;
    the per-item wrappers launch nothing."""
    x, kernel, scale, bias, _, _, gy = _train_case("fu_bwd_stats", shape, torch.float32, cuda)[2]
    want = {fu.fu_spectrum: 2, fu.fu_mix_stats: 1, fu.fu_mix_apply: 1, fu.fu_inverse: 2,
            fu.fu_bwd_stats_mix: 1, fu.fu_bwd_mix: 1, fu.fu_train_stats: 0,
            fu.fourier_unit_forward: 0, fu.fu_bwd_stats: 0, fu.fu_bwd_apply: 0}
    before = {f: f.launches for f in want}
    leaves = [t.clone().requires_grad_() for t in (x, kernel, scale, bias)]
    y, bmean, bvar = fu.fourier_unit_train(*leaves)
    grads = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert {f: f.launches - before[f] for f in want} == want
    x64, k64, s64, b64, gy64 = (t.double() for t in (x, kernel, scale, bias, gy))
    refs = fu.fourier_unit_train_plain(x64, k64, s64, b64)
    refs += fu.fourier_unit_backward_plain(x64, k64, s64, b64, *refs[1:], gy64)[:4]
    for out, ref in zip((y, bmean, bvar, *grads), refs):
        assert out.shape == ref.shape and torch.isfinite(out).all()
        rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("cmap", [(16, 16, 16), (8, 32, 32), (64, 16, 16), (32, 128, 128),
                                  (8, 48, 48)])
def test_item_plans_match_the_libraries(cuda, cmap):
    """The per-item plans that ``kernel_design`` reads, and the per-rank
    plans of the clustered kernels that ``item_design`` reads, are the
    kernels'."""
    for stem, exports in fu._RANK_FLOATS.items():
        lib = fu._library(stem)
        assert lib.ffc_item_floats(*cmap) == fu._item_floats(stem, *cmap)
        for kernel, export in exports.items():
            for ranks in (1, 2, 4, 8):
                assert getattr(lib, export)(*cmap, ranks) == fu._item_rank_floats(
                    kernel, *cmap, ranks)


# Every map of a generator or discriminator that kernel_design sends to
# SHARED for each clustered per-item kernel: the 32px generator's two, the
# 128px eval forward's (64, 16, 16) and the 48px generator's (16, 24, 24) and
# (8, 48, 48), whose backward apply and statistics fit only on 2 ranks or
# more; and (128, 16, 16), where the forward fits only on 8 ranks.
ITEM_MAPS = {"fourier_unit_fwd": [(16, 16, 16), (8, 32, 32), (64, 16, 16), (16, 24, 24),
                                  (8, 48, 48), (128, 16, 16)],
             "fu_bwd_apply": [(16, 16, 16), (8, 32, 32), (16, 24, 24), (8, 48, 48)],
             "fu_train_stats": [(16, 16, 16), (8, 32, 32), (16, 24, 24), (8, 48, 48)],
             "fu_bwd_stats": [(16, 16, 16), (8, 32, 32), (16, 24, 24), (8, 48, 48)]}
ITEM_CASES = [(name, cmap) for name, maps in ITEM_MAPS.items() for cmap in maps]
# The kernel_design wrapper of each clustered kernel's wrapper.
ITEM_DESIGN = {"fourier_unit_fwd": "forward", "fu_bwd_apply": "bwd_apply",
               "fu_train_stats": "stats", "fu_bwd_stats": "stats"}


def _item_case(name, shape, dtype, device):
    """(wrapper, plain version, arguments) of a clustered per-item kernel."""
    if name == "fourier_unit_fwd":
        return fourier_unit_forward, fourier_unit_forward_plain, _inputs(shape, dtype, device)
    return _train_case(name, shape, dtype, device)


def _check_item(name, shape, dtype, device, tol):
    """One launch of the wrapper's clustered kernel (and, but for the
    forward, one ``fu_reduce``), every output within ``tol`` rel-max of the
    plain version in f64, the same bits on a second launch."""
    wrapper, plain, args = _item_case(name, shape, dtype, device)
    assert fu._design(ITEM_DESIGN[name], args[0]) == fu.SHARED
    before = (wrapper.launches, fu.fu_reduce.launches)
    outs = wrapper(*args)
    torch.cuda.synchronize()
    reduces = 0 if name == "fourier_unit_fwd" else 1
    assert (wrapper.launches, fu.fu_reduce.launches) == (before[0] + 1, before[1] + reduces)
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = plain(*(a.double() for a in args))
    refs = refs if isinstance(refs, tuple) else (refs,)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= tol, rel
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("name,cmap", ITEM_CASES)
def test_item_kernels_match_plain(cuda, name, cmap, batch, dtype, tol):
    """The clustered per-item forward, statistics, backward sums and
    backward apply at every map that kernel_design sends to SHARED, at
    batch 1, 7 and 64 (ranks from item_design), against their plain
    versions in f64 (the backward with ``relu_margin_bias``): rel-max 1e-4
    in f32, 2e-2 in bf16; the same bits on two launches."""
    _check_item(name, (batch,) + cmap, dtype, cuda, tol)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("name,cmap", [("fourier_unit_fwd", (16, 16, 16)),
                                       ("fu_bwd_apply", (8, 32, 32)),
                                       ("fu_bwd_apply", (16, 24, 24)),
                                       ("fu_train_stats", (16, 16, 16)),
                                       ("fu_train_stats", (8, 32, 32)),
                                       ("fu_bwd_stats", (8, 32, 32)),
                                       ("fu_bwd_stats", (16, 24, 24))])
def test_item_kernels_at_every_cluster_size(cuda, monkeypatch, name, cmap, ranks):
    """Each cluster size the rule can pick, forced, in f32: within 1e-4
    rel-max of the plain version in f64, the same bits on two launches."""
    monkeypatch.setattr(fu, "item_design", lambda *a: ranks)
    _check_item(name, (3,) + cmap, torch.float32, cuda, 1e-4)


@pytest.mark.parametrize("shape", [(2, 6, 10, 14), (3, 4, 12, 9), (2, 3, 5, 7)])
@pytest.mark.parametrize("name", list(ITEM_MAPS))
def test_item_kernels_take_maps_of_odd_sizes(cuda, name, shape):
    """Maps whose H is no multiple of 4, whose W is odd or whose C is odd
    (the stages' unaligned loads and clamped tiles), in f32: within 1e-4
    rel-max of the plain version in f64, the same bits on two launches."""
    _check_item(name, shape, torch.float32, cuda, 1e-4)


@pytest.mark.parametrize("ranks", [3, 16])
@pytest.mark.parametrize("name", list(ITEM_MAPS))
def test_item_kernels_raise_on_a_refused_cluster(cuda, monkeypatch, name, ranks):
    """A cluster shape the kernels refuse (3 ranks, or 16: beyond the
    portable 8) raises, with no fallback."""
    wrapper, _, args = _item_case(name, (2, 16, 16, 16), torch.float32, cuda)
    monkeypatch.setattr(fu, "item_design", lambda *a: ranks)
    with pytest.raises(RuntimeError, match="launch failed"):
        wrapper(*args)


@pytest.mark.parametrize("name", ["fu_train_stats", "fu_bwd_stats"])
def test_item_statistics_give_the_same_bits_every_launch(cuda, name):
    """The clustered statistics and backward sums at the 32px step's
    (64, 8, 32, 32) in bf16, 2 ranks per item: four launches, one set of
    bits (fixed-order sums per rank, then ``fu_reduce``)."""
    wrapper, _, args = _item_case(name, (64, 8, 32, 32), torch.bfloat16, cuda)
    first = wrapper(*args)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(wrapper(*args), first))


# fu_reduce's partial-sum shapes, (rows, cols, count): on the main path the
# 32px statistics (count > 0), backward sums and gK rows at both maps and
# the 128px staged ones, (B * chunks, 4C) and (B * chunks, 4C^2); narrow
# (rows, 3C) sums, the shapes the BN backward reduce gave it before it
# summed its own channels; and an odd column count.
REDUCE_CASES = [(64, 64, 64 * 16 * 9), (64, 64, 0), (64, 1024, 0), (64, 32, 64 * 32 * 17),
                (64, 32, 0), (64, 256, 0), (192, 256, 64 * 16 * 9), (192, 256, 0),
                (192, 16384, 0), (512, 128, 64 * 32 * 17), (512, 128, 0), (512, 4096, 0),
                (1, 1536, 0), (4, 768, 0), (16, 384, 0), (64, 384, 0), (256, 384, 0),
                (37, 1001, 0)]


@pytest.mark.parametrize("rows,cols,count", REDUCE_CASES)
def test_fu_reduce_matches_plain(cuda, rows, cols, count):
    """Every output within 1e-4 rel-max of the plain version in f64; one
    launch, counted by shape; the public wrapper and the callers' entry give
    the same bits on every launch."""
    partial = torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows + cols))
    partial = partial.to(cuda)
    before = (fu.fu_reduce.launches, fu.fu_reduce.launches_by_map[(rows, cols)])
    out = fu.fu_reduce(partial, count)
    torch.cuda.synchronize()
    assert (fu.fu_reduce.launches, fu.fu_reduce.launches_by_map[(rows, cols)]) == (
        before[0] + 1, before[1] + 1)
    ref = fu.fu_reduce_plain(partial.double(), count)
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    assert torch.equal(fu._reduce(partial, count), out)
    assert torch.equal(fu.fu_reduce(partial, count), out)


def test_fu_reduce_takes_unaligned_rows_and_raises_on_a_refused_launch(cuda, monkeypatch):
    """A partial that starts off a 16-byte boundary takes the scalar loads;
    a cluster shape the kernel refuses raises, with no fallback."""
    base = torch.randn(64 * 128 + 1, generator=torch.Generator().manual_seed(5)).to(cuda)
    partial = base[1:].view(64, 128)
    out = fu.fu_reduce(partial)
    ref = partial.double().sum(0)
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    monkeypatch.setattr(fu, "reduce_design", lambda *a: (4, 3))
    with pytest.raises(RuntimeError, match="launch failed"):
        fu.fu_reduce(partial.contiguous())


# The 128px generator's five packed maps at batch 64, and a map whose planes
# are no multiple of 16 bytes in bf16 (the element-wise loads).
STATS_SHAPES = [(64, 512, 8, 8), (64, 256, 16, 16), (64, 128, 32, 32), (64, 128, 64, 64),
                (64, 128, 128, 128), (64, 192, 10, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_bn_stats_one_launch_matches_plain(cuda, shape, dtype):
    """bn_stats goes from x to (mean, var) in one launch and no fu_reduce:
    both within 1e-5 rel-max of the plain version in f64, the same bits on
    two launches."""
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(6)) * 1.5 + 0.3)
    x = x.to(cuda, dtype)
    before = (ba.bn_stats.launches, fu.fu_reduce.launches)
    outs = ba.bn_stats(x)
    torch.cuda.synchronize()
    assert (ba.bn_stats.launches, fu.fu_reduce.launches) == (before[0] + 1, before[1])
    for out, ref in zip(outs, ba.bn_stats_plain(x.double())):
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(outs, ba.bn_stats(x)))


def test_bn_stats_takes_an_unaligned_map_and_raises_on_a_refused_launch(cuda, monkeypatch):
    """A map that starts off a 16-byte boundary takes the element-wise
    loads; a cluster shape the kernel refuses raises."""
    shape = (8, 64, 16, 16)
    flat = torch.randn(8 * 64 * 256 + 1, generator=torch.Generator().manual_seed(7))
    x = flat.to(cuda, torch.bfloat16)[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    for out, ref in zip(ba.bn_stats(x), ba.bn_stats_plain(x.double())):
        assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    monkeypatch.setattr(ba, "stats_design", lambda *a: (True, 5))
    with pytest.raises(RuntimeError, match="launch failed"):
        ba.bn_stats(x.contiguous())


def _reduce_args(shape, dtype, device, noise, seed=8):
    """(x, g, mean, var, scale, bias[, n_l, n_g, cl]) for the backward
    reduce and the apply, drawn on the card; the statistics in f64,
    rounded to f32."""
    b, c, h, w = shape
    gen = torch.Generator(device).manual_seed(seed)
    randn = lambda *size: torch.randn(size, generator=gen, device=device)
    x, gy = (randn(*shape) * 1.5 + 0.3).to(dtype), randn(*shape).to(dtype)
    n_l, n_g = randn(b, 1, h, w).to(dtype), randn(b, 1, h, w).to(dtype)
    scale, bias, wn = randn(c).abs() + 0.5, randn(c) * 0.2, randn(c) * 0.3
    mean, var = (t.float() for t in ba.bn_stats_plain(x.double()))
    return x, gy, mean, var, scale, bias, wn, ((n_l, n_g, c // 2) if noise else ())


def _within_bf16_ulps(out, ref, ulps=2):
    ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())).item() - 7)
    return (out.float() - ref.float()).abs().max().item() <= ulps * ulp


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_bn_bwd_reduce_one_launch_matches_f64(cuda, shape, dtype, noise):
    """bn_bwd_reduce goes from (x, g[, n_l, n_g]) to its sums in one launch
    and no fu_reduce: every sum within 1e-5 rel-max of the plain version's
    sums in f64 (from the op's own u), the same bits on two launches."""
    x, gy, mean, var, scale, bias, _, noise_args = _reduce_args(shape, dtype, cuda, noise)
    args = (x, gy, mean, var, scale, bias) + noise_args
    before = (ba.bn_bwd_reduce.launches, fu.fu_reduce.launches)
    sums = ba.bn_bwd_reduce(*args)
    torch.cuda.synchronize()
    assert (ba.bn_bwd_reduce.launches, fu.fu_reduce.launches) == (before[0] + 1, before[1])
    refs = ba.bn_bwd_reduce_plain(*args, sum_dtype=torch.float64)
    assert len(sums) == len(refs) == (3 if noise else 2)
    for out, ref in zip(sums, refs):
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(sums, ba.bn_bwd_reduce(*args)))


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_bn_gelu_apply_matches_plain_at_the_packed_maps(cuda, shape, noise):
    """bf16 out within 2 bf16 ulps of the plain version on the same inputs,
    the same bits on two launches."""
    x, _, mean, var, scale, bias, wn, noise_args = _reduce_args(shape, torch.bfloat16, cuda,
                                                               noise)
    args = (x, mean, var, scale, bias) + ((wn,) + noise_args if noise else ())
    out = ba.bn_gelu_apply(*args)
    ref = ba.bn_gelu_apply_plain(*args)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert _within_bf16_ulps(out, ref)
    assert torch.equal(out, ba.bn_gelu_apply(*args))


def test_bn_gelu_apply_groups_that_straddle_cl(cuda, monkeypatch):
    """Groups of 3 channels and cl = 5: the group [3, 6) loads both noise
    maps and takes n_l below cl, n_g from it."""
    x, _, mean, var, scale, bias, wn, (n_l, n_g, _) = _reduce_args((4, 12, 16, 16), torch.float32,
                                                                   cuda, True)
    args = (x, mean, var, scale, bias, wn, n_l, n_g, 5)
    monkeypatch.setattr(ba, "apply_design", lambda *a: (True, 64, 3))
    out = ba.bn_gelu_apply(*args)
    ref = ba.bn_gelu_apply_plain(*(a.double() if torch.is_tensor(a) else a for a in args))
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("where", ["tail", "unaligned"])
def test_apply_and_reduce_take_element_wise_loads(cuda, where, noise):
    """Planes of 200 bytes in bf16, and a map that starts off a 16-byte
    boundary: both kernels take units of one value and match the plain
    version (the apply within 2 bf16 ulps, the sums within 1e-5 of f64)."""
    shape = (64, 192, 10, 10) if where == "tail" else (8, 64, 16, 16)
    x, gy, mean, var, scale, bias, wn, noise_args = _reduce_args(shape, torch.bfloat16, cuda,
                                                                 noise)
    if where == "unaligned":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
        assert x.data_ptr() % 16 != 0
    b, c, h, w = shape
    assert not ba.apply_design(b, c, h * w, 2, x.data_ptr() % 16 == 0)[0]
    assert not ba.bwd_reduce_design(b, c, h * w, 2, x.data_ptr() % 16 == 0)[0]
    apply_args = (x, mean, var, scale, bias) + ((wn,) + noise_args if noise else ())
    assert _within_bf16_ulps(ba.bn_gelu_apply(*apply_args), ba.bn_gelu_apply_plain(*apply_args))
    reduce_args = (x, gy, mean, var, scale, bias) + noise_args
    for out, ref in zip(ba.bn_bwd_reduce(*reduce_args),
                        ba.bn_bwd_reduce_plain(*reduce_args, sum_dtype=torch.float64)):
        assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def test_bn_bwd_reduce_raises_on_a_refused_launch(cuda, monkeypatch):
    """A cluster shape the kernel refuses raises, with no fallback."""
    x, gy, mean, var, scale, bias, _, _ = _reduce_args((8, 64, 16, 16), torch.bfloat16, cuda,
                                                       False)
    monkeypatch.setattr(ba, "bwd_reduce_design", lambda *a: (True, 5))
    with pytest.raises(RuntimeError, match="launch failed"):
        ba.bn_bwd_reduce(x, gy, mean, var, scale, bias)


# --- the training step as a CUDA graph ----------------------------------------------

# A narrow 32px pair (ngf 16, z 32) against a three-conv SN discriminator.
NARROW_G = dict(z_size=32, ngf=16, ratio_g=0.25, mg=4, channel_mults=(4, 2, 1))
NARROW_D = dict(ladder=((16, 3, 1), (32, 4, 2), (32, 4, 2)), head_size=8)


@pytest.fixture
def deterministic(cuda):
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(False)


def _narrow_trainer(device, **options):
    g = FFCGenerator(**NARROW_G, generator=torch.Generator().manual_seed(0))
    d = SNConvDiscriminator(**NARROW_D, generator=torch.Generator().manual_seed(1))
    return GANTrainer(g, d, z_size=NARROW_G["z_size"], total_steps=50, seed=3, device=device,
                      dtype="f32", **options)


def _reals(n, batch=8, resolution=32, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, batch, resolution, resolution, 3, generator=g) * 2 - 1


def _trainer_state(trainer):
    """Every tensor a step changes, by name: parameters and buffers, the
    optimizer moments and update counts, the learning rates and their
    counts, and the two generators' states."""
    state = {f"g.{k}": v for k, v in trainer.g.state_dict().items()}
    state.update({f"d.{k}": v for k, v in trainer.d.state_dict().items()})
    for side, opt, model in (("g", trainer.g_opt, trainer.g), ("d", trainer.d_opt, trainer.d)):
        for name, p in model.named_parameters():
            state.update({f"{side}.{name}.{k}": v for k, v in opt.state[p].items()})
    for side, schedule in (("g", trainer.g_lr), ("d", trainer.d_lr)):
        state[f"{side}.lr"], state[f"{side}.count"] = schedule.lr, schedule.count
    state["z_generator"] = trainer.z_generator.get_state()
    state["noise_generator"] = trainer.noise_generator.get_state()
    return state


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    assert not differ, differ


@pytest.mark.parametrize("options", [
    dict(),
    dict(loss="wgan-gp", update_order="d_first", fused_dis_batch=False),
], ids=["default", "wgan-gp-d-first"])
def test_update_steps_replays_the_eager_step(deterministic, options):
    """f32 under deterministic algorithms, from one state: update_steps
    over 4 batches (an eager first step, the capture, 3 replays) against 4
    update_step calls gives the same losses and the same bits in every
    parameter, buffer, moment, learning rate and generator state."""
    graph, eager = (_narrow_trainer(deterministic, **options) for _ in range(2))
    reals = _reals(4)
    out = graph.update_steps(reals)
    ref = [eager.update_step(r.to(deterministic)) for r in reals]
    torch.cuda.synchronize()
    for key in ("loss_g", "loss_d"):
        assert out[key].shape == (4,) and out[key].is_cuda
        assert torch.equal(out[key], torch.stack([r[key] for r in ref])), key
    assert graph.step == eager.step == 4
    _assert_same_bits(_trainer_state(graph), _trainer_state(eager))


def test_update_step_and_update_steps_interleave(deterministic):
    """update_step, update_steps over 3 batches, update_step, then
    update_steps over 2 batches (replays only) against 7 eager steps: the
    graph continues the generators' streams and reads the state in place."""
    graph, eager = (_narrow_trainer(deterministic) for _ in range(2))
    reals = _reals(7).to(deterministic)
    losses = [graph.update_step(reals[0])["loss_g"]]
    losses += list(graph.update_steps(reals[1:4])["loss_g"])
    losses += [graph.update_step(reals[4])["loss_g"]]
    losses += list(graph.update_steps(reals[5:7])["loss_g"])
    ref = [eager.update_step(r)["loss_g"] for r in reals]
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(losses), torch.stack(ref))
    assert graph.step == eager.step == 7
    _assert_same_bits(_trainer_state(graph), _trainer_state(eager))


def test_sngan_pair_launches_each_kernel_as_counted(cuda):
    """The 32px FFC generator against FFCDiscriminator (Adam, separate real
    and fake D passes) at batch 8: per step, G's FourierUnit maps run 2
    training forwards and 1 backward, D's 3 and 3 (the G phase's pass on the
    fakes, the fake and the real pass), all per item; the first
    update_steps call counts its eager step and the capture, replays count
    nothing."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    maps = {(16, 16, 16): (5, 4), (8, 32, 32): (2, 1), (32, 8, 8): (3, 3)}
    assert all(fu.kernel_design(w, *m, limit) == fu.SHARED for m in maps
               for w in ("forward", "stats", "bwd_apply"))
    trainer = GANTrainer(FFCGenerator.for_resolution(32), FFCDiscriminator(), optimizer="adam",
                         device=cuda)
    wrappers = {"fu_train_stats": 0, "fourier_unit_forward": 0, "fu_bwd_stats": 1,
                "fu_bwd_apply": 1}  # 0: per forward, 1: per backward

    def launches():
        return {w: dict(getattr(fu, w).launches_by_map) for w in wrappers}

    def check(before, steps):
        after = launches()
        for w, side in wrappers.items():
            got = {m: after[w].get(m, 0) - before[w].get(m, 0) for m in maps}
            assert got == {m: steps * n[side] for m, n in maps.items()}, w

    reals = _reals(2, batch=8)
    for _ in range(2):
        before = launches()
        out = trainer.update_step(reals[0])
        torch.cuda.synchronize()
        check(before, 1)
        assert all(torch.isfinite(v) for v in out.values())
    before = launches()
    out = trainer.update_steps(reals)
    torch.cuda.synchronize()
    check(before, 2)
    before = launches()
    out = trainer.update_steps(reals)
    torch.cuda.synchronize()
    check(before, 0)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_a_failed_capture_raises_and_runs_no_step_in_its_place(deterministic):
    """A step that syncs with the host cannot be captured: update_steps
    raises, and the trainer holds the eager first step's state, bit for bit
    (f32, deterministic algorithms: Adam turns the rounding of a gradient
    near 0 into a full step), so no step was rerun eagerly."""
    cuda = deterministic
    graph, eager = (_narrow_trainer(cuda) for _ in range(2))
    hinge = LOSS_PAIRS["hinge"][0]

    def syncing(logits):
        loss = hinge(logits)
        loss.item()
        return loss

    graph.gen_loss = syncing
    reals = _reals(3)
    with pytest.raises(RuntimeError):
        graph.update_steps(reals)
    torch.cuda.synchronize()
    eager.update_step(reals[0].to(cuda))
    torch.cuda.synchronize()
    assert graph.step == eager.step == 1
    # the generators' states are left out: the aborted capture had them
    # registered
    drop = ("z_generator", "noise_generator")
    _assert_same_bits(*({k: v for k, v in _trainer_state(t).items() if k not in drop}
                        for t in (graph, eager)))


# --- the FourierUnit op's eval-mode gradient and double backward -------------------

# A map of each design: per item (clustered, on one block's plan and, at
# 48x48, on the per-rank plans alone), staged, and per item in a workspace
# (96x96).
GRAD_MAPS = [(8, 16, 16, 16), (2, 32, 64, 64), (2, 8, 48, 48), (2, 8, 96, 96)]


def _grad_inputs(shape, device, train):
    """f32 (x, K, scale, bias, mean, var, gy) with biases that keep every
    pre-activation clear of the ReLU's kink (``relu_margin_bias``) under the
    statistics the op normalises with: the batch statistics in training."""
    x, kernel, scale, bias, mean, var = _inputs(shape, torch.float32, device, seed=7)
    if train:
        mean, var = (t.float() for t in fu.fu_train_stats_plain(x.double(), kernel.double()))
    bias, _ = fu.relu_margin_bias(x, kernel, scale, bias, mean, var)
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(8)).to(device)
    return x, kernel, scale, bias, mean, var, gy


def _backward_launches():
    return [w.launches for w in (fu.fu_bwd_stats, fu.fu_bwd_apply, fu.fu_bwd_stats_mix,
                                 fu.fu_bwd_mix)]


@pytest.mark.parametrize("shape", GRAD_MAPS)
def test_eval_op_gradients_come_from_the_kernels(cuda, shape):
    """An eval-mode FourierUnit's gx, gK, gscale and gbias from the
    backward kernels (the apply with zero sums) against the plain backward
    in f64 within 1e-4 rel-max; one launch of the backward sums and of the
    apply (their staged stages on the staged map)."""
    x, kernel, scale, bias, mean, var, gy = _grad_inputs(shape, cuda, train=False)
    leaves = [t.clone().requires_grad_() for t in (x, kernel, scale, bias)]
    y = fu.fourier_unit_eval(*leaves, mean, var)
    before = _backward_launches()
    outs = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    staged = fu._design("stats", x) == fu.STAGED
    added = [a - b for a, b in zip(_backward_launches(), before)]
    assert added == ([0, 0, 1, 1] if staged else [1, 1, 0, 0])
    refs = fu.fourier_unit_backward_plain(
        *(t.double() for t in (x, kernel, scale, bias, mean, var, gy)), train=False)
    for name, out, ref in zip(("gx", "gK", "gscale", "gbias"), outs, refs):
        err = (out.double() - ref).abs().max() / ref.abs().max()
        assert err <= 1e-4, (name, err.item())


def _penalty_grads(op, leaves, gy, w):
    """The gradient in ``leaves`` of Σ w·(∂(Σ gy·y)/∂x)², y = op(*leaves)."""
    y = op(*leaves)
    (gx,) = torch.autograd.grad((gy * y).sum(), leaves[0], create_graph=True)
    return torch.autograd.grad((w * gx * gx).sum(), leaves, materialize_grads=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", GRAD_MAPS[:2])
def test_double_backward_matches_plain(cuda, shape, train):
    """The gradient of a gradient norm through the training op (the
    backward's kernels, its second-order term from the plain backward with
    the statistics recomputed) and through the eval op, against autograd
    twice through the plain forward in f64, within 1e-4 rel-max per
    tensor."""
    x, kernel, scale, bias, mean, var, gy = _grad_inputs(shape, cuda, train)
    w = torch.rand(shape, generator=torch.Generator().manual_seed(9)).to(cuda) + 0.5
    if train:
        op = lambda *a: fu.fourier_unit_train(*a)[0]
        plain = lambda *a: fu.fourier_unit_train_plain(*a)[0]
    else:
        op = lambda *a: fu.fourier_unit_eval(*a, mean, var)
        plain = lambda *a: fu.fourier_unit_forward_plain(*a, mean.double(), var.double())
    ours = _penalty_grads(op, [t.clone().requires_grad_() for t in (x, kernel, scale, bias)],
                          gy, w)
    refs = _penalty_grads(plain, [t.double().requires_grad_() for t in (x, kernel, scale, bias)],
                          gy.double(), w.double())
    for name, out, ref in zip(("x", "K", "scale", "bias"), ours, refs):
        err = (out.double() - ref).abs().max() / max(ref.abs().max(), 1e-30)
        assert err <= 1e-4, (name, err.item())


# --- the conditional path and wgan-gp as CUDA graphs -------------------------------

COND_G = dict(z_size=32, ngf=16, num_classes=10)


def _pair_trainer(device, pair, **options):
    """A narrow trainer of ``pair``: "cond32" (the cifar32 preset at ngf 16
    against CondSNDiscriminator, fused D pass), "train-cond" (the cDCGAN
    pair on one channel at 16px: D's decaying input noise, bce, Adam, D
    first, d_progress_arg) or "sngan-gp" (the narrow FFC generator against
    FFCDiscriminator, wgan-gp, Adam)."""
    seeds = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    common = dict(z_size=32, total_steps=50, seed=3, device=device, dtype="f32")
    if pair == "cond32":
        g = FFCCondGenerator.for_preset("cifar32", **COND_G, generator=seeds[0])
        d = CondSNDiscriminator(num_classes=10, resolution=32, generator=seeds[1])
        common.update(conditional=True, num_classes=10, fused_dis_batch=True)
    elif pair == "train-cond":
        g = CondDCGANGenerator(nz=32, nc=1, ngf=16, generator=seeds[0])
        d = CondDCGANDiscriminator(nc=1, ndf=16, use_noise=True, generator=seeds[1])
        common.update(conditional=True, num_classes=10, loss="bce", optimizer="adam",
                      update_order="d_first", d_progress_arg=True)
    else:
        g = FFCGenerator(**NARROW_G, generator=seeds[0])
        d = FFCDiscriminator(generator=seeds[1])
        common.update(loss="wgan-gp", optimizer="adam")
    return GANTrainer(g, d, **common, **options)


def _pair_batches(pair, n, device):
    resolution, channels = (16, 1) if pair == "train-cond" else (32, 3)
    g = torch.Generator().manual_seed(6)
    reals = (torch.rand(n, 8, resolution, resolution, channels, generator=g) * 2 - 1).to(device)
    labels = torch.randint(0, 10, (n, 8), generator=g).to(device)
    return reals, None if pair == "sngan-gp" else labels


@pytest.mark.parametrize("pair", ["cond32", "train-cond", "sngan-gp"])
def test_update_steps_replays_the_eager_step_of_the_new_paths(deterministic, pair):
    """f32 under deterministic algorithms, from one state: update_steps over
    4 batches (labels (K, B) into the graph's static buffer beside the
    reals; the progress read from the device step count) against 4
    update_step calls: the same losses and the same bits in every
    parameter, buffer, moment, learning rate and generator state."""
    graph, eager = (_pair_trainer(deterministic, pair) for _ in range(2))
    reals, labels = _pair_batches(pair, 4, deterministic)
    out = graph.update_steps(reals, labels)
    ref = [eager.update_step(r, None if labels is None else labels[i])
           for i, r in enumerate(reals)]
    torch.cuda.synchronize()
    for key in ("loss_g", "loss_d"):
        assert torch.equal(out[key], torch.stack([r[key] for r in ref])), key
    assert graph.step == eager.step == 4
    _assert_same_bits(_trainer_state(graph), _trainer_state(eager))
    if pair == "train-cond":
        assert torch.equal(graph.step_count, eager.step_count) and graph.step_count.item() == 4


def test_generate_between_update_steps_leaves_the_replays_unchanged(deterministic):
    """update_steps, generate(z, labels, uint8=True), update_steps against
    the two update_steps calls alone: the same bits everywhere, and the
    images uint8 NHWC."""
    a, b = (_pair_trainer(deterministic, "cond32") for _ in range(2))
    reals, labels = _pair_batches("cond32", 4, deterministic)
    z = torch.randn(8, 32, generator=torch.Generator().manual_seed(2)).to(deterministic)
    a.update_steps(reals[:2], labels[:2])
    images = a.generate(z, labels[0], uint8=True)
    floats = a.generate(z, labels[0])
    a.update_steps(reals[2:], labels[2:])
    b.update_steps(reals[:2], labels[:2])
    b.update_steps(reals[2:], labels[2:])
    torch.cuda.synchronize()
    assert images.dtype == torch.uint8 and images.shape == (8, 32, 32, 3)
    assert floats.dtype == torch.float32 and torch.isfinite(floats).all()
    assert a.g.training
    _assert_same_bits(_trainer_state(a), _trainer_state(b))



# --- the comparator models' layers and pairs -----------------------------------

def _bf16_gap(out, ref):
    """rel-max of a bf16 result against the f32 one."""
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


# bf16 against f32 on the same weights and on the f32 inputs rounded to bf16:
# both compute from the same operands, the bf16 path rounds each product's
# output (and, in the attention, q, k, v and attn) to bf16, 2^-9 of each
# value, a few of which add up.
BF16_LAYER_TOL = 2e-2


def test_upsample_bilinear_bf16_matches_f32(cuda):
    from fastfourierconvolution_tpu_torch.ops.conv import upsample_bilinear_torch

    x = torch.randn(8, 64, 16, 24, generator=torch.Generator().manual_seed(0)).to(cuda)
    x = x.bfloat16()
    ref = upsample_bilinear_torch(x.float(), 2)
    out = upsample_bilinear_torch(x, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (8, 64, 32, 48)
    assert _bf16_gap(out, ref) <= BF16_LAYER_TOL
    want = torch.nn.functional.interpolate(x.float(), scale_factor=2, mode="bilinear",
                                           align_corners=False)
    assert (ref - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("stride,padding,size", [(1, 0, 1), (2, 1, 8)], ids=["stem", "up"])
def test_sn_conv_transpose_bf16_matches_f32(cuda, stride, padding, size):
    from fastfourierconvolution_tpu_torch.nn.layers import SNConvTranspose2d, reset_parameters

    layer = SNConvTranspose2d(96, 48, 4, stride=stride, padding=padding)
    reset_parameters(torch.nn.Sequential(layer), torch.Generator().manual_seed(1))
    layer.to(cuda).eval()
    x = torch.randn(16, 96, size, size, generator=torch.Generator().manual_seed(2)).to(cuda)
    x = x.bfloat16()
    with torch.no_grad():
        ref, out = layer(x.float()), layer(x)
    assert out.dtype == torch.bfloat16
    assert _bf16_gap(out, ref) <= BF16_LAYER_TOL


def test_self_attention_bf16_matches_f32(cuda):
    from fastfourierconvolution_tpu_torch.nn.layers import SelfAttention

    attn = SelfAttention(64)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for conv, scale in ((attn.query, 0.3), (attn.key, 0.3), (attn.value, 1.0)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * scale / 8)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.1)
        attn.gamma.fill_(1.0)
    attn.to(cuda)
    x = torch.randn(16, 64, 16, 16, generator=g).to(cuda).bfloat16()
    with torch.no_grad():
        ref, ref_map = attn(x.float())
        out, out_map = attn(x)
    assert out.dtype == torch.bfloat16 and out_map.dtype == torch.float32
    assert out_map.shape == (16, 256, 256)
    assert _bf16_gap(out, ref) <= BF16_LAYER_TOL
    assert _bf16_gap(out_map, ref_map) <= BF16_LAYER_TOL


def _comparator_trainer(device, preset):
    """A narrow pair of ``preset`` ("sagan": conv_dim 16, z 16; "resnet32":
    ngf = ndf 32, z 16) with the preset's trainer settings."""
    from fastfourierconvolution_tpu_torch import (
        SAGANDiscriminator,
        SAGANGenerator,
        SNGANDiscriminator,
        SNGANGenerator,
        TupleHeadWrapper,
    )

    seeds = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    common = dict(z_size=16, total_steps=50, seed=3, device=device, dtype="f32")
    if preset == "sagan":
        g = TupleHeadWrapper(SAGANGenerator(image_size=32, z_dim=16, conv_dim=16,
                                            generator=seeds[0]))
        d = TupleHeadWrapper(SAGANDiscriminator(image_size=32, conv_dim=16, generator=seeds[1]))
        with torch.no_grad():
            g.module.attn2.gamma.fill_(0.5)
            d.module.attn1.gamma.fill_(0.5)
        common.update(loss="wgan-gp", optimizer="adam", b1=0.0, b2=0.9, lr=1e-4, d_lr=4e-4,
                      num_dis_updates=5, update_order="d_first")
    else:
        g = SNGANGenerator(nz=16, ngf=32, num_blocks=3, generator=seeds[0])
        d = SNGANDiscriminator(ndf=32, num_blocks=3, generator=seeds[1])
        common.update(b1=0.0, b2=0.9)
    return GANTrainer(g, d, **common)


@pytest.mark.parametrize("preset", ["sagan", "resnet32"])
def test_update_steps_replays_the_eager_step_of_the_comparators(deterministic, preset):
    """f32 under deterministic algorithms, from one state: update_steps over
    4 batches against 4 update_step calls of a narrow ``preset`` pair (the
    sagan pair's self-attention twice differentiated under the gradient
    penalty in the captured graph): the same losses and the same bits in
    every parameter, buffer, moment, learning rate and generator state."""
    reals = _reals(4).to(deterministic)
    # The first sagan step of a process (f32, deterministic algorithms)
    # differed in its last bits from every later one, with no graph in play
    # (a library's first use on the card); a throwaway trainer takes it, so
    # that both trainers below run later steps whatever ran before.
    _comparator_trainer(deterministic, preset).update_step(reals[0])
    graph, eager = (_comparator_trainer(deterministic, preset) for _ in range(2))
    out = graph.update_steps(reals)
    ref = [eager.update_step(r) for r in reals]
    torch.cuda.synchronize()
    for key in ("loss_g", "loss_d"):
        assert torch.isfinite(out[key]).all()
        assert torch.equal(out[key], torch.stack([r[key] for r in ref])), key
    assert graph.step == eager.step == 4
    _assert_same_bits(_trainer_state(graph), _trainer_state(eager))
