"""The work a function needs, counted from shapes: the yardstick of the
roofline and peak shares.

``fu_work``, ``bn_work`` and ``bound`` are frozen copies of the functions
the port's chip smoke test used for its kernel table: each input byte read
once and each output byte written once, FFT-sized transforms (5 N log2 N
per complex length-N transform, half that for a real one), the (2C, 2C)
mix over the half spectrum, and the elementwise work, against the
published H100 SXM peaks. They count the work of a function at a shape,
never what an implementation launches, so a share reads the same work
whoever computes it.

``train_step_flops`` and ``request_flops`` count a whole training step
or served request: the
convolutions and products of the plain reference (``reference/``) under
``torch.utils.flop_counter``'s formulas, run on the meta device with every
FourierUnit replaced by a stand-in that does no arithmetic, plus each
FourierUnit call's FFT-sized work from ``fu_work``.
"""

from __future__ import annotations

import math

# Published H100 SXM peaks (dense, 700 W): HBM bytes/s, and FLOP/s for the
# operands' type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def fu_work(kernel, shape, itemsize, maps=1, co=None):
    """(bytes, FLOPs) a FourierUnit kernel's function needs at ``shape``:
    each input read once and each output written once (maps in the model
    dtype, the (2C,) vectors and gK in f32, K in the model dtype, the
    staged kernels' spectra in f32); FFT-sized transforms (5 N log2 N per
    complex length-N transform, half that for a real one), each (2C, 2C)
    product over the spectrum, and the elementwise BN work. ``maps``: the
    maps one ``fu_spectrum`` launch transforms. ``co``: on an out-channel
    slice the mix's Co out-channels. For ``fu_reduce`` ``shape`` is the
    (rows, cols) of its f32 partial sums."""
    if kernel == "fu_reduce":
        rows, cols = shape
        return (rows + 1) * cols * 4, rows * cols
    b, c, h, w = shape
    co = c if co is None else co
    c2, co2, s = 2 * c, 2 * co, h * (w // 2 + 1)
    n_map, n_out = b * c * h * w * itemsize, b * co * h * w * itemsize
    k_bytes, vec = c2 * co2 * itemsize, co2 * 4
    dft_of = lambda n: 2.5 * w * math.log2(w) * n * h + 5 * h * math.log2(h) * n * (w // 2 + 1)
    dft, dft_out = dft_of(c), dft_of(co)
    mix = 2 * c2 * co2 * s
    spec, spec_out = b * c2 * s * 4, b * co2 * s * 4
    nbytes, per_item = {
        "fu_spectrum": (maps * (n_map + spec), maps * dft),
        "fu_mix_apply": (spec + spec_out + k_bytes + 4 * vec, mix + 6 * co2 * s),
        "fu_mix_stats": (spec + k_bytes + 2 * vec, mix + 3 * co2 * s),
        "fu_bwd_stats_mix": (spec + spec_out + k_bytes + 6 * vec, mix + 8 * co2 * s),
        "fu_inverse": (spec + n_map, dft),
        "fu_bwd_mix": (2 * spec + spec_out + k_bytes + 6 * vec + c2 * co2 * 4,
                       3 * mix + 12 * co2 * s),
        "fourier_unit_fwd": (n_map + n_out + k_bytes + 4 * vec, dft + dft_out + mix + 6 * co2 * s),
        "fu_train_stats": (n_map + k_bytes + 2 * vec, dft + mix + 3 * co2 * s),
        "fu_bwd_stats": (n_map + n_out + k_bytes + 6 * vec, dft + dft_out + mix + 8 * co2 * s),
        "fu_bwd_apply": (2 * n_map + n_out + k_bytes + 6 * vec + c2 * co2 * 4,
                         2 * dft + dft_out + 3 * mix + 12 * co2 * s),
        # the training op: forward x -> (y, bmean, bvar), m computed once;
        # backward (x, gy) -> (gx, gK, gscale, gbias)
        "train_forward": (2 * n_map + k_bytes + 4 * vec, 2 * dft + mix + 9 * c2 * s),
        "train_backward": (3 * n_map + k_bytes + 6 * vec + c2 * c2 * 4,
                           3 * dft + 3 * mix + 20 * c2 * s),
    }[kernel]
    return int(nbytes), int(b * per_item)


def bn_work(kernel, shape, itemsize, noise):
    """(bytes, FLOPs) a fused BN + GELU kernel's function needs at the
    packed map ``shape``: each map read once and written once (x, g, out,
    dx in the model dtype, the (B, 1, H, W) noise maps and their cotangents
    with ``noise``), the (C,) f32 vectors; f32 operations per element,
    tanh counted as one: stats 3, apply 14, reduce 22, dx 24, and 2 more
    each with the noise fold."""
    b, c, h, w = shape
    n, rows, vec = b * c * h * w, b * h * w, c * 4
    maps = 2 * rows * itemsize if noise else 0
    nbytes, ops = {
        "bn_stats": (n * itemsize + 2 * vec, 3),
        "bn_gelu_apply": (2 * n * itemsize + 4 * vec + (maps + vec if noise else 0), 14),
        "bn_bwd_reduce": (2 * n * itemsize + 4 * vec + maps + (3 if noise else 2) * vec, 22),
        "bn_bwd_dx": (3 * n * itemsize + 8 * vec + (maps + vec if noise else 0), 24),
    }[kernel]
    return int(nbytes), (ops + (2 if noise and kernel != "bn_stats" else 0)) * n


def bound(kernel, shape, itemsize, dtype_name, noise=False, maps=1, co=None):
    """(bound ms, "bytes" or "operations", bytes, FLOPs). The BN kernels
    compute in f32 whatever the map's dtype."""
    if kernel.startswith("bn_"):
        nbytes, flops = bn_work(kernel, shape, itemsize, noise)
        dtype_name = "float32"
    elif kernel in ("fu_mix_apply", "fu_mix_stats", "fu_bwd_stats_mix", "fu_inverse",
                    "fu_bwd_mix"):  # f32 spectra in
        nbytes, flops = fu_work(kernel, shape, itemsize, co=co)
        dtype_name = "float32"
    else:
        nbytes, flops = fu_work(kernel, shape, itemsize, maps, co)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes, flops


def calls_bound_ms(calls, itemsize, dtype_name):
    """The least ms a list of ``(function, shape, noise)`` calls needs:
    the sum of each call's :func:`bound`."""
    return sum(bound(kernel, shape, itemsize, dtype_name, noise=noise)[0]
               for kernel, shape, noise in calls)


def counted_flops(fn) -> int:
    """FLOPs of the matmuls and convolutions ``fn`` runs (forward and
    backward alike), by ``torch.utils.flop_counter``'s formulas, counted
    in a dispatch mode of its own."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                total += formula(*args, **kwargs, out_val=out)
            return out

    with Count():
        fn()
    return int(total)


def _meta_tensors(leaves):
    import torch

    return {name: torch.zeros(shape, device="meta") for name, shape, _ in leaves}


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one training step of the pair at ``batch``: G's update (G
    forward, D forward, the backward into G's parameters) and one D update
    (G forward without gradients, D forward on [fakes; reals], the
    backward into D's parameters), with each FourierUnit's training
    forward and backward counted by :func:`fu_work`."""
    import torch

    from .reference.ffc_gan import (discriminator_forward, discriminator_leaves,
                                    generator_forward, generator_leaves, is_buffer)
    from .shapes import fourier_unit_calls

    t_g, t_d = _meta_tensors(generator_leaves(cfg)), _meta_tensors(discriminator_leaves(cfg))
    r = cfg["resolution"]
    noise = lambda shape: torch.zeros(shape, device="meta")
    z = torch.zeros((batch, cfg["z_size"]), device="meta")

    def step():
        g_params = [t_g[k].requires_grad_() for k in t_g if not is_buffer(k)]
        fake = generator_forward(t_g, cfg, z, True, noise, stub_fourier_units=True)
        loss = -discriminator_forward(t_d, cfg, fake).mean()
        torch.autograd.grad(loss, g_params, allow_unused=True)
        for p in g_params:
            p.requires_grad_(False)
        with torch.no_grad():
            fake = generator_forward(t_g, cfg, z, True, noise, stub_fourier_units=True)
        d_params = [t_d[k].requires_grad_() for k in t_d if not is_buffer(k)]
        real = torch.zeros((batch, cfg["out_channels"], r, r), device="meta")
        loss = discriminator_forward(t_d, cfg, torch.cat([fake, real])).mean()
        torch.autograd.grad(loss, d_params, allow_unused=True)

    fu = sum(fu_work(k, s, 2)[1] for k, s, _ in fourier_unit_calls(cfg, batch, True))
    return counted_flops(step) + fu


def request_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one served request of ``batch`` latents: the generator's
    eval forward, each FourierUnit's eval forward by :func:`fu_work`."""
    import torch

    from .reference.ffc_gan import generator_forward, generator_leaves
    from .shapes import fourier_unit_calls

    t_g = _meta_tensors(generator_leaves(cfg))
    z = torch.zeros((batch, cfg["z_size"]), device="meta")
    fu = sum(fu_work(k, s, 2)[1] for k, s, _ in fourier_unit_calls(cfg, batch, False))
    return counted_flops(lambda: generator_forward(t_g, cfg, z, False,
                                                   stub_fourier_units=True)) + fu
