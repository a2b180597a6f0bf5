"""The readings each comparison limit is set from, for one cell, on the
card at the cell's own size: not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3 --out F.json

For each of ``--seeds`` seeds it reads the numbers of a sound run of the
program (set-up and, for serving, a short window at the cell's load, then
the comparison with the f32 reference, as a run compares). For the first
``--controls`` of them it also reads the same numbers with the reference
put in the program's place, computed

- in the precision below the configuration's (bf16 -> fp8: the products'
  operands scaled onto float8 e4m3, their cotangents onto e5m2): the
  control;
- and with the faults the cell can have: for training, its losses over
  half of the batch (the mean over the rest); for serving, each request's
  first image altered where it is produced (the image of other latents).

A training state left unchanged reads 1 on ``change_gap`` by that
number's definition and needs no run. Writes every reading to ``--out``
and prints one line a seed.

With ``--look`` (training cells) it reads instead, on each seed, where the
numbers that sound runs spread on come from: the program's numbers, the
same numbers of two witnesses (the reference rounded to bf16, the
configuration's precision, against the f32 reference; the program's own
f32 path, TF32 off, against the f32 reference with f32 noise), and for
each squeeze-and-excite ``se.fc1`` leaf the rows whose first gradient is
exactly zero on one side only and the leaf's change gap without them.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_pairs(drv, produce):
    """(request, served, reference) for the kept requests, ``produce``
    standing in for the program."""
    from benchmark.drivers.serve import latents

    out = []
    for i, _ in drv.kept:
        z = latents(drv.cfg, drv.traffic, drv.seed, i)
        out.append((i, produce(i, z), drv.reference_images(z)))
    return out


def readings(drv, kind: str, controls: bool, window_s: float) -> dict:
    from benchmark.reference.ffc_gan import Precision

    fp8 = Precision("fp8")
    out = {}
    if kind == "train":
        from benchmark.drivers.train import compare

        drv.setup()
        drv.release()
        raw = {"reference": drv.reference_readings(), "program": drv.readings}
        if controls:
            raw["control_fp8"] = drv.reference_readings(fp8)
            raw["fault_half_batch"] = drv.reference_readings(
                batch_rows=drv.traffic["batch"] // 2)
        out = {k: compare(v, raw["reference"]) for k, v in raw.items() if k != "reference"}
        out["raw"] = raw
        return out
    from benchmark.drivers.serve import compare, latents

    drv.setup()
    drv.window(window_s)
    drv.release()
    out["program"] = drv.check()
    if controls:
        out["control_fp8"] = compare(serve_pairs(drv, lambda i, z: drv.reference_images(z, fp8)))

        def altered(i, z):
            images = drv.reference_images(z)
            images[0] = drv.reference_images(latents(drv.cfg, drv.traffic, drv.seed + 1, i))[0]
            return images

        out["fault_altered_image"] = compare(serve_pairs(drv, altered))
    return out


def zero_rows(prog: dict, reference: dict, floor: float) -> dict:
    """For each kept leaf: its rows, the rows whose first gradient is all
    zero on the program's side only, on the reference's only, on both;
    the gap of its change norms (as the comparison takes it, against
    ``floor``) with every row and without the rows zero on one side."""
    import torch

    def gap(a, b):
        na, nb = float(torch.linalg.vector_norm(a)), float(torch.linalg.vector_norm(b))
        return abs(na - nb) / max(nb, floor, 1e-30)

    out = {}
    for name, (g_p, d_p) in prog["kept"].items():
        g_r, d_r = reference["kept"][name]
        z_p = (g_p.flatten(1) == 0).all(dim=1)
        z_r = (g_r.flatten(1) == 0).all(dim=1)
        both_sides = ~(z_p ^ z_r)
        out[name] = {"rows": int(z_p.numel()), "zero_program_only": int((z_p & ~z_r).sum()),
                     "zero_reference_only": int((z_r & ~z_p).sum()),
                     "zero_both": int((z_p & z_r).sum()), "gap": gap(d_p, d_r),
                     "gap_without": gap(d_p[both_sides], d_r[both_sides])}
    return out


def change_floor(reference: dict) -> float:
    """The median change norm of the leaves the comparison's change
    numbers take (those the reference's first gradient moves)."""
    from benchmark.drivers.train import FREE_LEAF_SHARE, _median

    grads = reference["grad_norms"]
    floor = FREE_LEAF_SHARE * _median(list(grads.values()))
    return _median([reference["delta_norms"][n] for n in grads if grads[n] >= floor])


def look(cell, seed: int, device) -> dict:
    """The look at one seed of a training cell (see the module's text)."""
    import dataclasses

    from benchmark.drivers.train import compare
    from benchmark.harness import driver
    from benchmark.reference.ffc_gan import Precision, f32_products

    drv = driver(cell, seed, device)
    drv.keep = (".se.fc1.",)
    drv.setup()
    drv.release()
    ref32 = drv.reference_readings()
    ref_bf16 = drv.reference_readings(Precision("bf16"))
    floor = change_floor(ref32)
    out = {"program": compare(drv.readings, ref32),
           "reference_bf16": compare(ref_bf16, ref32),
           "rows_program": zero_rows(drv.readings, ref32, floor),
           "rows_reference_bf16": zero_rows(ref_bf16, ref32, floor)}
    cfg = json.loads(json.dumps(cell.config))
    cfg["train"].update(dtype="float32", noise_dtype="float32")
    drv32 = driver(dataclasses.replace(cell, config=cfg), seed, device)
    drv32.keep = drv.keep
    with f32_products():
        drv32.setup()
    drv32.release()
    ref32_f32_noise = drv32.reference_readings()
    out["program_f32"] = compare(drv32.readings, ref32_f32_noise)
    out["rows_program_f32"] = zero_rows(drv32.readings, ref32_f32_noise,
                                        change_floor(ref32_f32_noise))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--seed-list", type=int, nargs="*", default=None,
                        help="these seeds instead of --seeds from --first-seed")
    parser.add_argument("--window", type=float, default=1.0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--look", action="store_true",
                        help="read the look at each seed instead (training cells)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import driver
    from benchmark.registry import Bench

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = Bench.load(ROOT).cell(args.workload)
    rows = []
    seeds = args.seed_list or [args.first_seed + 7919 * k for k in range(args.seeds)]
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if args.look:
            row = {"seed": seed, **look(cell, seed, "cuda:0")}
        else:
            drv = driver(cell, seed, "cuda:0")
            row = {"seed": seed, **readings(drv, cell.traffic["kind"], k < args.controls,
                                            args.window)}
            del drv
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "raw"}), flush=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
