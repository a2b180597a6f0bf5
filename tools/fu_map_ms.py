#!/usr/bin/env python3
"""Device ms of the four FourierUnit wrappers at one map, as a checkout runs it.

    cd <checkout> && python3 <this file> [--shape B,C,H,W] [--calls N] [--out FILE]

Imports ``fastfourierconvolution_tpu_torch`` from the working directory, so
the same script reads any checkout of the package: run from the parent
commit's root it reads the design that commit gave the map (the workspace
kernels at the 256px generator's (64, 32, 256, 256) before the split
planes took it). Each wrapper (``fourier_unit_forward``,
``fu_train_stats``, ``fu_bwd_stats``, ``fu_bwd_apply``) is called once to
warm up and then ``--calls`` times (1 by default) under ``torch.profiler``,
in bf16 on seeded inputs; the device ms per call is the sum of every device
event of the window over the calls, its reduction and stages included.
Each wrapper's outputs are also digested (SHA-256 of their bytes as f32),
so two checkouts' digests say whether they compute the same bits. Prints
one JSON line, {"card": ..., "shape": [...], "design": {wrapper: design},
"device_ms": {wrapper: ms}, "sha256": {wrapper: hex}}, and writes it to
FILE with ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", default="64,32,256,256")
    parser.add_argument("--calls", type=int, default=1)
    parser.add_argument("--out")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    if not torch.cuda.is_available():
        print("fu_map_ms: CUDA is not available", file=sys.stderr)
        return 1
    shape = tuple(int(v) for v in args.shape.split(","))
    b, c, h, w = shape
    device = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x, gy = (torch.randn(shape, generator=g).to(device, torch.bfloat16) for _ in range(2))
    kernel = (torch.randn(2 * c, 2 * c, generator=g) * 0.2).to(device, torch.bfloat16)
    scale, var = ((torch.randn(2 * c, generator=g).abs() + 0.5).to(device) for _ in range(2))
    bias, mean, gscale, gbias = ((torch.randn(2 * c, generator=g) * 0.1).to(device)
                                 for _ in range(4))
    calls = {
        "fourier_unit_fwd": lambda: fu.fourier_unit_forward(x, kernel, scale, bias, mean, var),
        "fu_train_stats": lambda: fu.fu_train_stats(x, kernel),
        "fu_bwd_stats": lambda: fu.fu_bwd_stats(x, kernel, scale, bias, mean, var, gy),
        "fu_bwd_apply": lambda: fu.fu_bwd_apply(x, kernel, scale, bias, mean, var, gy, gscale,
                                                gbias),
    }
    wrappers = {"fourier_unit_fwd": "forward", "fu_train_stats": "stats",
                "fu_bwd_stats": "stats", "fu_bwd_apply": "bwd_apply"}
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    result = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        "shape": list(shape),
        "design": {k: fu.kernel_design(v, c, h, w, limit) for k, v in wrappers.items()},
        "device_ms": {},
        "sha256": {},
    }
    for name, fn in calls.items():
        outs = fn()
        outs = outs if isinstance(outs, tuple) else (outs,)
        result["sha256"][name] = hashlib.sha256(
            b"".join(t.float().cpu().numpy().tobytes() for t in outs)).hexdigest()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
                continue
            t = getattr(evt, "self_device_time_total", None)
            total += (getattr(evt, "self_cuda_time_total", 0) if t is None else t) / 1000.0
        result["device_ms"][name] = total / args.calls if total else None
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
