#!/usr/bin/env python3
"""Time the clustered per-item FourierUnit kernels at every cluster size.

    cd <checkout> && python3 tools/item_design_sweep.py [--out FILE]

Imports ``fastfourierconvolution_tpu_torch`` and ``chip_smoke`` from the
working directory. For each map that ``kernel_design`` sends to SHARED for
the forward (``fourier_unit_forward``), the statistics (``fu_train_stats``),
the backward sums (``fu_bwd_stats``) or the backward apply
(``fu_bwd_apply``), in bf16 at batch 1, 7 and 64, it forces each cluster
size R (1, 2, 4 or 8, dividing C, each rank's plan within the card's shared
memory) in place of ``item_design``'s pick and prints the profiler's device
ms per launch of the kernel and the CUDA-event ms per wrapper call, with the
rule's pick marked. One JSON line per reading, then a summary line; with
``--out`` the lines also go to FILE. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

BATCHES = (1, 7, 64)
TRAIN_MAPS = [(16, 16, 16), (8, 32, 32), (16, 24, 24), (8, 48, 48)]
MAPS = {"fourier_unit_fwd": [(16, 16, 16), (8, 32, 32), (64, 16, 16), (16, 24, 24),
                             (8, 48, 48)],
        "fu_train_stats": TRAIN_MAPS, "fu_bwd_stats": TRAIN_MAPS, "fu_bwd_apply": TRAIN_MAPS}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    out_path = parser.parse_args().out
    import torch

    import chip_smoke as cs
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    if not torch.cuda.is_available():
        print("item_design_sweep: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rule = fu.item_design
    lines = [json.dumps({"card": cs.card_line()})]
    best = {}
    for name, maps in MAPS.items():
        _, plan, symbol = cs.ITEM_KERNELS[name]
        for cmap in maps:
            for b in BATCHES:
                shape = (b,) + cmap
                if name == "fourier_unit_fwd":
                    call, args = fu.fourier_unit_forward, cs.fu_inputs(shape, torch.bfloat16,
                                                                       device, cs.SEED)
                else:
                    # the wrapper's own arguments, a prefix of the backward's
                    call, _, args, _ = next(c[1:] for c in cs.train_cases(
                        shape, torch.bfloat16, device, cs.SEED) if c[0] == name)
                pick = rule(b, *cmap, limit)
                for ranks in fu._ITEM_RANKS:
                    if cmap[0] % ranks or fu._item_rank_floats(plan, *cmap, ranks) * 4 > limit:
                        continue
                    fu.item_design = lambda *a, r=ranks: r
                    try:
                        ms = cs.time_ms(lambda: call(*args))
                        dev = cs.kernel_device_ms(lambda: call(*args), symbol, iters=20)
                    finally:
                        fu.item_design = rule
                    row = {"name": name, "shape": list(shape), "dtype": "bfloat16",
                           "ranks": ranks, "rule": ranks == pick, "device_ms": dev, "ms": ms}
                    lines.append(json.dumps(row))
                    print(lines[-1], flush=True)
                    key = (name, shape)
                    if dev is not None and (key not in best or dev < best[key][1]):
                        best[key] = (ranks, dev)
    summary = {f"{k[0]} {list(k[1])}": {"fastest_ranks": r, "device_ms": d,
                                        "rule_ranks": rule(k[1][0], *k[1][1:], limit)}
               for k, (r, d) in best.items()}
    lines.append(json.dumps({"summary": summary}))
    print(lines[-1])
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
