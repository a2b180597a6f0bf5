"""Nothing in the benchmark imports JAX or the JAX package, checked on the
source and in a process that runs a cell; the plain reference imports
nothing of the measured package either. Module names are compared by
their top-level name, the part before the first dot, whole."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fastfourierconvolution_tpu"}
BENCH = ROOT / "benchmark"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"fastfourierconvolution_tpu_torch"})


def test_names_are_compared_whole():
    assert "fastfourierconvolution_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


RUNTIME = r"""
import sys, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import tempfile, time
from pathlib import Path
import torch
torch.set_num_threads(1)
from conftest import tiny_spec_and_files
from fastfourierconvolution_tpu_torch.nn.layers import set_fast_gelu
set_fast_gelu(True)
from benchmark.registry import Bench
from benchmark.harness import run_cell
from benchmark.calibrate import readings
from benchmark import run
root = Path(tempfile.mkdtemp())
bench = Bench(tiny_spec_and_files(root), root / "benchmark")
for w in ("tiny.train", "tiny.serve"):
    run_cell(bench, bench.cell(w), 3, 0.2, False, "cpu", time.perf_counter())
    for m in bench.spec["per_layer"]:
        bench.reader(m["name"])
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax_module():
    code = RUNTIME.format(root=str(ROOT), tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_sees_a_submodule(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()
