#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA source of the port (one nvcc per source, in parallel);
3. the FourierUnit kernel against its plain PyTorch version at the
   shapes the 32px generator gives it at batch 64, in f32 (TF32 off) and
   bf16, with kernel and plain times; the torch.fft-vs-factor-form gap is
   printed as information (cuFFT's C2R makes no promise for the
   non-Hermitian spectrum the FourierUnit inverts);
4. serve the full-width 32px generator in bf16 (seeded weights, BN
   running statistics calibrated on a seeded batch): 8 requests of batch
   64, then batch 1 and batch 7, with the kernel's launch counts (in all
   and by FourierUnit map) set to 0 before them and read after them;
   then batch-64 requests back to back for a few seconds for the served
   img/s; one request is held against the same weights run through the
   plain op;
5. a ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, where CUDA is absent.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

SEED = 0
BATCH = 64
N_REQUESTS = 8
# (B, C, H, W) of the generator's two FourierUnits at serving batch 64:
# block1's g2g on 16x16 maps, block2's on 32x32.
FU_SHAPES = [(BATCH, 16, 16, 16), (BATCH, 8, 32, 32)]
FU_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Whole-request uint8 agreement, kernel vs plain op on the same weights.
# f32: both sides agree to ~1e-6, so only a truncation boundary can flip a
# level. bf16: the plain op rounds to bf16 after every stage where the
# kernel keeps f32, and the difference passes through two more blocks.
U8_MAX_LEVELS = {"float32": 1, "bfloat16": 16}
U8_MEAN_LEVELS = {"float32": 0.01, "bfloat16": 1.0}
# Published H100 SXM peaks (dense, 700 W): HBM bytes/s, and FLOP/s for the
# operands' type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# Served requests timed back to back for the throughput reading.
TIMED_SECONDS = 3.0
TPU_KERNEL = "fastfourierconvolution_tpu/ops/pallas/fourier_unit.py:657,1124,1405"


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0].strip()


def fu_inputs(shape, dtype, device, seed):
    import torch

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


def fu_work(shape, itemsize):
    """(bytes, FLOPs) the FourierUnit forward needs: x and y once, the
    operands once; FFT-sized transforms (5 N log2 N per complex length-N
    transform, half that for a real one), the mix and the BN tail."""
    b, c, h, w = shape
    wf = w // 2 + 1
    nbytes = 2 * b * c * h * w * itemsize + 4 * c * c * itemsize + 4 * 2 * c * 4
    rfft_w = 2.5 * w * math.log2(w) * c * h     # over W, one per (c, h) row
    fft_h = 5 * h * math.log2(h) * c * wf       # over H, one per (c, v) column
    per_item = (
        2 * (rfft_w + fft_h)                    # forward and inverse
        + 2 * (2 * c) ** 2 * h * wf             # (2C, 2C) mix
        + 6 * 2 * c * h * wf                    # BN, ReLU, c weights
    )
    return nbytes, int(b * per_item)


def time_ms(fn, iters, warmup=5):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, iters=10, top=8):
    """Device time per call of ``fn`` from torch.profiler, counting only
    device-side events (kernels, copies): (total ms, launches, the ``top``
    of them by device time as (name, ms, launches))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        rows.append((evt.key, t / iters / 1000.0, evt.count // iters))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def check_fourier_unit(device):
    """Phase 3; returns the bf16 rows for the kernels line."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier as F
    from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
        EPS,
        fourier_unit_forward,
        fourier_unit_forward_plain,
    )

    rows = []
    for shape in FU_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = fu_inputs(shape, dtype, device, SEED)
            y = fourier_unit_forward(*args)
            torch.cuda.synchronize()
            ref = fourier_unit_forward_plain(*args).float()
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"kernel {shape} {name}: non-finite output")
            abs_err = (y.float() - ref).abs().max().item()
            rel = abs_err / ref.abs().max().item()
            ms = time_ms(lambda: fourier_unit_forward(*args), iters=200)
            plain_ms = time_ms(lambda: fourier_unit_forward_plain(*args), iters=50)
            _, _, kernels = device_breakdown(lambda: fourier_unit_forward(*args))
            dev_ms = sum(t for key, t, _ in kernels if "fourier_unit_fwd_kernel" in key)
            nbytes, flops = fu_work(shape, y.element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOP_PER_S[name] * 1e3
            log(
                f"fourier_unit_fwd {shape} {name}: rel-max {rel:.3e} "
                f"(tol {FU_REL_TOL[name]:g}), max-abs {abs_err:.3e}, kernel "
                f"{ms:.4f} ms/call (profiler device {dev_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms/call, bound {max(bytes_ms, ops_ms):.5f} ms "
                f"({nbytes} B, {flops} FLOP)"
            )
            if not rel <= FU_REL_TOL[name]:
                raise AssertionError(
                    f"kernel {shape} {name}: rel-max {rel} > {FU_REL_TOL[name]}"
                )
            if dtype == torch.float32:
                x, kernel, scale, bias, mean, var = args
                c = shape[1]
                f_r, f_i = F.rfft2_ortho_fft(x)
                m = torch.einsum("bjuv,jd->bduv", torch.cat([f_r, f_i], 1), kernel)
                col = lambda t: t[:, None, None]
                r = torch.relu((m - col(mean)) * torch.rsqrt(col(var) + EPS)
                               * col(scale) + col(bias))
                y_fft = F.irfft2_ortho_fft(r[:, :c], r[:, c:], shape[2:])
                gap = (y_fft - ref).abs().max().item()
                log(f"  info: torch.fft (cuFFT) vs factor form, max-abs {gap:.3e}"
                    f" (rel {gap / ref.abs().max().item():.3e})")
            else:
                rows.append({
                    "name": "fourier_unit_fwd",
                    "route": "cuda",
                    "source": "fastfourierconvolution_tpu_torch/csrc/fourier_unit_fwd.cu",
                    "replaces": TPU_KERNEL,
                    "shape": list(shape),
                    "dtype": name,
                    "max_abs_err": abs_err,
                    "ms": ms,
                    "device_ms": dev_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": None,
                })
    return rows


def calibrate_running_stats(model, z):
    """Set every BatchNorm's and FourierUnit's running statistics to the
    f32 batch statistics of its input on ``z``, layer by layer."""
    import torch

    from fastfourierconvolution_tpu_torch.nn.ffc import FourierUnit
    from fastfourierconvolution_tpu_torch.nn.layers import BatchNorm
    from fastfourierconvolution_tpu_torch.ops.fourier import rfft2_ortho

    def set_stats(mod, v):
        mod.running_mean.copy_(v.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(v.var(dim=(0, 2, 3), unbiased=False))

    def bn_hook(mod, args):
        set_stats(mod, args[0].float())

    def fu_hook(mod, args):
        f_r, f_i = rfft2_ortho(args[0].float())
        z_spec = torch.cat([f_r, f_i], dim=1)
        set_stats(mod, torch.einsum("bjuv,jd->bduv", z_spec, mod.mix_kernel.float()))

    hooks = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(bn_hook))
        elif isinstance(m, FourierUnit):
            hooks.append(m.register_forward_pre_hook(fu_hook))
    try:
        with torch.no_grad():
            model(z, torch.float32)
    finally:
        for h in hooks:
            h.remove()


def serve(device, card):
    """Phase 4; returns the kernel's launches by (C, H, W) over the served
    requests."""
    import torch

    import fastfourierconvolution_tpu_torch.nn.ffc as ffc_module
    from fastfourierconvolution_tpu_torch import Generator
    from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
        fourier_unit_forward,
        fourier_unit_forward_plain,
    )

    server = Generator.from_preset(
        32, generator=torch.Generator().manual_seed(SEED), device=device, dtype="bf16"
    )
    g = torch.Generator().manual_seed(SEED + 1)
    calibrate_running_stats(server.model, torch.randn(256, 128, generator=g).to(device))
    requests = [torch.randn(BATCH, 128, generator=g) for _ in range(N_REQUESTS)]
    requests += [torch.randn(1, 128, generator=g), torch.randn(7, 128, generator=g)]
    server.generate(requests[0])  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()

    fourier_unit_forward.launches = 0
    fourier_unit_forward.launches_by_map.clear()
    images, per_request = [], []
    for z in requests:
        before = fourier_unit_forward.launches
        images.append(server.generate(z))
        per_request.append(fourier_unit_forward.launches - before)
    torch.cuda.synchronize()
    launches = fourier_unit_forward.launches
    by_map = dict(fourier_unit_forward.launches_by_map)

    for z, im in zip(requests, images):
        if im.shape != (z.shape[0], 32, 32, 3) or im.dtype != torch.uint8:
            raise AssertionError(f"request gave {tuple(im.shape)} {im.dtype}")
    if per_request != [2] * len(requests) or launches != 2 * len(requests):
        raise AssertionError(f"kernel launches per request {per_request}")
    if by_map != {tuple(s[1:]): len(requests) for s in FU_SHAPES}:
        raise AssertionError(f"kernel launches by map {by_map}")
    spread = images[0].float().std().item()
    if not spread > 5.0:
        raise AssertionError(f"images are flat (std {spread:.2f} levels)")
    floats = server.generate(requests[0], uint8=False)
    if not torch.isfinite(floats.float()).all():
        raise AssertionError("non-finite generator output")
    # Throughput: batch-64 requests back to back for TIMED_SECONDS of
    # host clock, synchronised at the end.
    z = requests[0]
    n_timed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        for _ in range(20):
            server.generate(z)
        n_timed += 20
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    img_s = n_timed * BATCH / timed_s
    wall_ms = timed_s / n_timed * 1e3
    busy_ms, n_launch, top = device_breakdown(lambda: server.generate(requests[0]))
    log(f"batch-{BATCH} request: {wall_ms:.3f} ms wall (unprofiled), device busy "
        f"{busy_ms:.3f} ms in {n_launch} device launches (profiler), idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for name, ms, count in top:
        log(f"  device {ms:.4f} ms in {count} launches: {name[:90]}")
    log(f"served {len(requests)} requests ({N_REQUESTS} x {BATCH}, 1, 7): "
        f"{launches} kernel launches, per request {per_request}; image std "
        f"{spread:.1f} levels")
    log(f"served {by_map} kernel launches by (C, H, W)")
    log(f"throughput: {img_s:.1f} img/s at batch {BATCH}, bf16 "
        f"({n_timed} requests, {n_timed * BATCH} images in {timed_s:.3f} s, "
        f"host clock; {card})")

    for dtype in ("bfloat16", "float32"):
        server.dtype = getattr(torch, dtype)
        kern = server.generate(requests[0]).int()
        with mock.patch.object(ffc_module, "fourier_unit_forward", fourier_unit_forward_plain):
            plain = server.generate(requests[0]).int()
        diff = (kern - plain).abs().float()
        log(f"request vs plain op, {dtype}: max {int(diff.max())} levels, "
            f"mean {diff.mean().item():.4f} (bars {U8_MAX_LEVELS[dtype]}, "
            f"{U8_MEAN_LEVELS[dtype]})")
        if diff.max() > U8_MAX_LEVELS[dtype] or diff.mean() > U8_MEAN_LEVELS[dtype]:
            raise AssertionError(f"served images differ from the plain op ({dtype})")
    server.dtype = torch.bfloat16
    return by_map


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from fastfourierconvolution_tpu_torch.ops import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for path in libs.values():
        build_log = path.with_name(path.name + ".log")
        if build_log.exists():
            for line in build_log.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log("  ptxas:", line.strip())

    rows = check_fourier_unit(device)
    by_map = serve(device, card)
    for row in rows:
        row["launches"] = by_map[tuple(row["shape"][1:])]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
