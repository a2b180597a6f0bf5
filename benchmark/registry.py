"""Everything the benchmark runs, found by name.

``BENCHMARK.json`` names the cells (workloads), configurations and metrics.
Each piece lives in a file of its own under the benchmark's directory, so
that a new cell, configuration, traffic mix or per-layer metric is new
files and entries, never an edit:

- ``configs/<config>.json``: the model's sizes and training settings;
- ``traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``kind`` names the driver that runs it (``drivers/<kind>.py``);
- ``limits/<workload>.json``: the limit of each number the cell's
  comparison with the plain reference computes;
- ``metrics/<metric>.py``: the reader of each metric, ``read(run)``;
- ``layers/<layer>.txt``: the kernel names that belong to a layer, one
  substring a line.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


class Bench:
    """``BENCHMARK.json`` (``spec``) over the data files in ``data_dir``."""

    def __init__(self, spec: dict, data_dir: Path = BENCH_DIR):
        self.spec, self.data_dir = spec, Path(data_dir)

    @classmethod
    def load(cls, root: Path = ROOT) -> "Bench":
        path = Path(root) / "BENCHMARK.json"
        return cls(json.loads(path.read_text()), Path(root) / "benchmark")

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        path = self.data_dir / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        return path

    def _json(self, kind: str, name: str) -> dict:
        return json.loads(self._file(kind, name, ".json").read_text())

    def cell(self, workload: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        w = cells[workload]
        config_files = {c["name"]: c["file"] for c in self.spec["configs"]}
        config = json.loads((self.data_dir.parent / config_files[w["config"]]).read_text())
        applies = lambda m: workload in m.get("workloads", [workload])
        return Cell(
            name=workload, config=config, traffic=self._json("traffic", w["traffic"]),
            limits=self._json("limits", workload), chips=int(w["chips"]),
            end_to_end=[m for m in self.spec["end_to_end"] if applies(m)],
            per_layer=[m for m in self.spec["per_layer"] if applies(m)],
        )

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self._file("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def layer_kernels(self, layer: str) -> List[str]:
        """The kernel-name substrings of ``layers/<layer>.txt``."""
        lines = self._file("layers", layer, ".txt").read_text().splitlines()
        return [s.strip() for s in lines if s.strip() and not s.lstrip().startswith("#")]


def read_metrics(bench: Bench, metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value: Optional[float] = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
