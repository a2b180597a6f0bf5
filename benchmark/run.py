"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this directory
and the measured package. The cell needs as many CUDA cards as it names;
without them the run exits with code 2 and prints no result. It never
falls back to the CPU.

Standard output ends with one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
``setup_phases`` (the seconds of each part of set-up), and last ``checks``: each number compared with the plain reference beside
its limit. Standard error ends with the same checks, one a line.

Build, kernel and bytecode caches stay inside the checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# Modules that may not be loaded in the process that prints a result,
# compared by the top-level name (the part before the first dot).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fastfourierconvolution_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    # Python's compiled modules too: where the installation ships no
    # bytecode and the environment turns writing it off, every run would
    # compile torch's sources anew
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.path.insert(0, ROOT)
    from benchmark.registry import Bench

    bench = Bench.load(ROOT)
    cell = bench.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2

    from benchmark.harness import run_cell

    line = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    return report(line)


def report(line: dict) -> int:
    """Print the checks to standard error and the result line to standard
    output, unless a forbidden module was loaded (then exit code 3, no
    result)."""
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in line["setup_phases"].items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} at {c['where']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
