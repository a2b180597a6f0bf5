#!/usr/bin/env python3
"""Times of the fused BN backward's dx kernel, as a checkout runs it.

    cd <checkout> && python3 <this file> [--out FILE]

Imports ``fastfourierconvolution_tpu_torch`` from the working directory, so
the same script reads any checkout of the package (run it from the parent
commit's root and from the change's, in turns, in one call, to compare two
designs on one card). ``bn_bwd_dx`` is called on seeded inputs at the 128px
generator's five packed maps and the 256px generator's (64, 128, 256, 256),
in bf16 and f32, with and without the noise fold (cl = C / 2): three calls
to warm up, then the CUDA-event ms per call over a run of calls, and the
device ms per launch of ``bn_bwd_dx_kernel`` from ``torch.profiler``. Each
case's outputs (dx, and dn_l, dn_g with the noise fold) are digested
(SHA-256 of their bytes), so two checkouts' digests say whether they
compute the same bits. Prints a line per case and one JSON line, {"card":
..., "cases": [{"shape", "dtype", "noise", "design", "ms", "device_ms",
"sha256"}]}, and writes the JSON to FILE with ``--out``. With ``--sweep``
(a checkout that has ``bn_act.dx_design``) it times instead the noise
fold's launch at every cluster of 1, 2, 4 or 8 ranks (ceil(C / ranks)
channels a rank) and every number of threads a unit from 1 to one channel
a thread (grids of more than 40,000 blocks left out), and prints a line per
launch and the JSON {"card": ..., "sweep": [{"shape", "dtype", "cluster",
"lanes", "blocks", "rule", "device_ms"}]}. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

SHAPES = [(64, 512, 8, 8), (64, 256, 16, 16), (64, 128, 32, 32), (64, 128, 64, 64),
          (64, 128, 128, 128), (64, 128, 256, 256)]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, iters):
    """Profiler device ms per launch of ``bn_bwd_dx_kernel`` over ``iters``
    calls of ``fn``, or None where the profiler recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = launches = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and "bn_bwd_dx_kernel" in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            total += (getattr(evt, "self_cuda_time_total", 0) if t is None else t) / 1000.0
            launches += evt.count
    return total / launches if launches else None


def event_ms(fn, iters):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(shape, dtype, device):
    """(bn_bwd_dx's arguments x, g, mean, var, scale, bias, s1, s2, g_mean,
    g_var; the noise fold's w), seeded on the card."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    gen = torch.Generator(device).manual_seed(0)
    randn = lambda *size: torch.randn(size, generator=gen, device=device)
    x = (randn(*shape) * 1.5 + 0.3).to(dtype)
    gy = randn(*shape).to(dtype)
    mean, var = (t.float() for t in ba.bn_stats_plain(x))
    scale = torch.rand(shape[1], generator=gen, device=device) + 0.5
    bias, wn, s1, s2, g_mean, g_var = (randn(shape[1]) for _ in range(6))
    return (x, gy, mean, var, scale, bias, s1, s2, g_mean, g_var), wn


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    parser.add_argument("--sweep", action="store_true")
    opts = parser.parse_args()

    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    if not torch.cuda.is_available():
        print("bn_dx_ms: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    if opts.sweep:
        return sweep(device, opts.out)
    result = {"card": card_line(), "cases": []}
    for shape in SHAPES:
        b, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            args, wn = inputs(shape, dtype, device)
            x = args[0]
            for noise in (False, True):
                call = lambda: ba.bn_bwd_dx(*args, *((wn, c // 2) if noise else ()))
                for _ in range(3):
                    outs = call()
                torch.cuda.synchronize()
                outs = outs if isinstance(outs, tuple) else (outs,)
                digest = hashlib.sha256()
                for t in outs:
                    digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                design = (ba.dx_design(b, c, h * w, x.element_size(), True, noise)
                          if hasattr(ba, "dx_design") else "a row per thread, grid.y 2")
                iters = 20 if shape[2] <= 64 else 5
                case = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                        "noise": noise, "design": str(design), "ms": event_ms(call, iters),
                        "device_ms": device_ms(call, iters), "sha256": digest.hexdigest()}
                print(f"{shape} {case['dtype']} noise={noise}: {case['ms']:.4f} ms a call, "
                      f"device {case['device_ms']} ms a launch; {case['design']}", flush=True)
                result["cases"].append(case)
            del args, x
            torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    return 0


def sweep(device, out) -> int:
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    rule, result = ba.dx_design, {"card": card_line(), "sweep": []}
    for shape in SHAPES:
        b, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            args, wn = inputs(shape, dtype, device)
            x = args[0]
            chosen = rule(b, c, h * w, x.element_size(), True, True)
            vec = chosen[0]
            for cluster in (1, 2, 4, 8):
                group, lanes = -(-c // cluster), 1
                while lanes <= min(256, 1 << (group - 1).bit_length()):
                    design = (vec, lanes, group, cluster)
                    blocks = 1
                    for n in ba.dx_blocks(b, c, h * w, x.element_size(), *design):
                        blocks *= n
                    if blocks > 40000:
                        break
                    ba.dx_design = lambda *a, design=design: design
                    call = lambda: ba.bn_bwd_dx(*args, wn, c // 2)
                    for _ in range(3):
                        call()
                    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                           "cluster": cluster, "lanes": lanes, "blocks": blocks,
                           "rule": design == chosen,
                           "device_ms": device_ms(call, 20 if h <= 64 else 5)}
                    print(f"{shape} {row['dtype']} cluster {cluster} lanes {lanes}, {blocks} "
                          f"blocks{' (rule)' if row['rule'] else ''}: device "
                          f"{row['device_ms']} ms a launch", flush=True)
                    result["sweep"].append(row)
                    lanes *= 2
            ba.dx_design = rule
            del args, x
            torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
