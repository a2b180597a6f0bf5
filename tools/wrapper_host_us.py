#!/usr/bin/env python3
"""Host time per call of every CUDA kernel wrapper of the PyTorch port.

    cd <checkout> && python3 <this file> [--out FILE]

Imports ``fastfourierconvolution_tpu_torch`` from the working directory,
so the same script measures two checkouts of the package (run it from
each root in one session, on one card, in turns). Each wrapper is called
at one shape its training step gives it (bf16, batch 64): the per-item
FourierUnit wrappers at the 32px generator's (64, 16, 16, 16) map, the
staged ones at the 128px generator's (64, 32, 32, 32), ``fu_reduce`` at
(512, 128) with the mean/variance epilogue and at (512, 4096), the fused
BN wrappers (noise fold on) at the packed (64, 256, 16, 16). The host
time is the time to enqueue back-to-back calls without waiting for the
card, per call, after warm-up; a wrapper's time includes the reductions it
launches itself. Prints one JSON line, {"card": ..., "host_us": {wrapper:
us}}, and writes it to FILE with ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

ITERS, ROUNDS = 100, 5


def host_us(fn):
    """Least over ROUNDS of the host µs per call of ITERS calls of ``fn``."""
    import torch

    for _ in range(5):
        fn()
    best = float("inf")
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        best = min(best, (time.perf_counter() - t0) / ITERS * 1e6)
        torch.cuda.synchronize()
    return best


def calls(device):
    """{wrapper name: a call of it} at the shapes the docstring names."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    g = torch.Generator().manual_seed(0)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(shape, generator=g).to(device, dtype)
    vec = lambda n, base=0.0: (torch.rand(n, generator=g) * 0.5 + base).to(device)

    def fu_args(b, c, h, w):
        return randn(b, c, h, w), randn(2 * c, 2 * c) * 0.2, vec(2 * c, 0.5), vec(2 * c), \
            vec(2 * c), vec(2 * c, 0.5)

    x, k, scale, bias, mean, var = fu_args(64, 16, 16, 16)
    gy = randn(64, 16, 16, 16)
    xs, ks, ss, bs, ms, vs = fu_args(64, 32, 32, 32)
    z, gz = fu.fu_spectrum(xs, randn(64, 32, 32, 32))
    scratch = gz.clone()
    stats, sums = randn(512, 128, dtype=torch.float32), randn(512, 4096, dtype=torch.float32)
    xb = randn(64, 256, 16, 16)
    gb = randn(64, 256, 16, 16)
    n_l, n_g = randn(64, 1, 16, 16), randn(64, 1, 16, 16)
    sc, bi, wn, s1, s2 = (vec(256, 0.5) for _ in range(5))
    mb, vb = ba.bn_stats(xb)
    return {
        "fourier_unit_fwd": lambda: fu.fourier_unit_forward(x, k, scale, bias, mean, var),
        "fu_train_stats": lambda: fu.fu_train_stats(x, k),
        "fu_bwd_stats": lambda: fu.fu_bwd_stats(x, k, scale, bias, mean, var, gy),
        "fu_bwd_apply": lambda: fu.fu_bwd_apply(x, k, scale, bias, mean, var, gy, mean, var),
        "fu_spectrum": lambda: fu.fu_spectrum(xs),
        "fu_mix_apply": lambda: fu.fu_mix_apply(z, ks, ss, bs, ms, vs),
        "fu_mix_stats": lambda: fu.fu_mix_stats(z, ks),
        "fu_bwd_stats_mix": lambda: fu.fu_bwd_stats_mix(z, gz, ks, ss, bs, ms, vs),
        "fu_bwd_mix": lambda: fu.fu_bwd_mix(z, scratch, ks, ss, bs, ms, vs, ms, vs),
        "fu_inverse": lambda: fu.fu_inverse(z, torch.bfloat16, 32),
        "fu_reduce (512, 128) epilogue": lambda: fu.fu_reduce(stats, 64 * 32 * 17),
        "fu_reduce (512, 4096)": lambda: fu.fu_reduce(sums),
        "bn_stats": lambda: ba.bn_stats(xb),
        "bn_gelu_apply": lambda: ba.bn_gelu_apply(xb, mb, vb, sc, bi, wn, n_l, n_g, 128),
        "bn_bwd_reduce": lambda: ba.bn_bwd_reduce(xb, gb, mb, vb, sc, bi, n_l, n_g, 128),
        "bn_bwd_dx": lambda: ba.bn_bwd_dx(xb, gb, mb, vb, sc, bi, s1, s2, None, None, wn, 128),
    }


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_host_us: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "host_us": {name: round(host_us(fn), 2)
                                         for name, fn in calls(torch.device("cuda")).items()}}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
