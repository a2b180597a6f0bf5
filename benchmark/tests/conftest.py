"""Fixtures of the benchmark's tests: the repository root on the path,
and a copy of the benchmark with two tiny cells (a 32px-ladder pair at
ngf 8, batch 4, f32 with the tanh GELU) that a CPU can run in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The numbers the cells compare. Two f32 implementations of a tiny GAN
# step part by a few 1e-3 in a small leaf's first gradient; the faults read
# 1 (state unchanged) and over 0.4 (half of the batch) on these numbers.
TINY_LIMITS = {
    "tiny.train": {"loss1_gap": 1e-4, "grad_gap": 0.05, "grad_median_gap": 0.01,
                   "change_median_gap": 0.5},
    "tiny.serve": {"image_gap": 0.5},
}


def tiny_spec_and_files(root: Path, config: str = "fgan32") -> dict:
    """Copy the benchmark under ``root`` and add the tiny cells; returns
    the spec with them."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    cfg.update(ngf=8, train=dict(cfg["train"], dtype="float32", noise_dtype="float32"),
               serve={"dtype": "float32"})
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"kind": "train", "batch": 4, "steps_per_call": 3, "pool_calls": 2, "warm_calls": 1,
         "trace_steps": 2}))
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(
        {"kind": "serve", "batch": 4, "warm_requests": 1, "trace_requests": 2,
         "check_requests": 3}))
    for name, limits in TINY_LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
    spec["configs"].append({"name": "tiny", "source": "a tiny test size",
                            "file": "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1,
         "why": "tests"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1,
         "why": "tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.train" if "train" in m["workloads"][0] else "tiny.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny cells run many small ops, and several
    test workers' thread pools contend for the cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tanh_gelu():
    """The port's GELU in its tanh form at f32, the form the configurations'
    bf16 runs take and the reference computes."""
    from fastfourierconvolution_tpu_torch.nn.layers import set_fast_gelu

    set_fast_gelu(True)
    yield
    set_fast_gelu("policy")


@pytest.fixture
def tiny_bench(tmp_path, tanh_gelu):
    from benchmark.registry import Bench

    spec = tiny_spec_and_files(tmp_path)
    return Bench(spec, tmp_path / "benchmark")
