"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the plain reference, and the metrics read from what
the run recorded.

The driver of a cell is ``drivers/<kind>.py`` for its traffic's
``kind``. Every number the result reports is read by the metric's own
reader (``metrics/<name>.py``) from a :class:`Run`.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from .registry import Bench, Cell, read_metrics
from .trace import Trace


@dataclass
class Run:
    """What one run recorded, for the metric readers."""

    cell: Cell
    bench: Bench
    setup_s: float
    window: dict
    trace: Optional[Trace] = None
    traced: dict = field(default_factory=dict)

    @property
    def batch(self) -> int:
        return self.cell.traffic["batch"]

    def layer_s(self, layer: str) -> Optional[float]:
        """Device seconds in the traced window of the kernels that the
        layer's name file lists; None without a trace or where none ran."""
        if self.trace is None:
            return None
        seconds = self.trace.kernel_s(self.bench.layer_kernels(layer))
        return seconds if seconds > 0 else None


def driver(cell: Cell, seed: int, device):
    module = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    return module.Driver(cell, seed, device)


def judge(checks: List[tuple], limits: dict) -> List[dict]:
    """Each compared number beside the limit it may not exceed: ``{"name",
    "value", "limit", "where"}``, ``where`` the leaf, step or image that
    gave it. Only the numbers that ``limits`` names are compared."""
    missing = set(limits) - {name for name, _, _ in checks}
    if missing:
        raise ValueError(f"limits for numbers the comparison does not give: {sorted(missing)}")
    return [{"name": name, "value": value, "limit": limits[name], "where": where}
            for name, value, where in checks if name in limits]


def passed(check: dict) -> bool:
    return check["value"] <= check["limit"]


def device_line(device, trace: Optional[Trace]) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    line = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if trace is not None:
        line.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return line


def run_cell(bench: Bench, cell: Cell, seed: int, seconds: float, traced: bool,
             device, t0: float) -> dict:
    """One run; returns the result line's object. ``t0``: the process's
    start on ``time.perf_counter``'s clock, from which set-up counts.
    ``setup_phases`` gives the seconds of each part of set-up: the
    imports, the CUDA context, and the parts the driver marks in its
    ``marks`` as it sets up."""
    device = torch.device(device)
    drv = driver(cell, seed, device)
    marks = {"imports": time.perf_counter()}
    torch.empty(0, device=device)
    marks["context"] = time.perf_counter()
    drv.marks = marks
    drv.setup()
    setup_s = time.perf_counter() - t0
    phases, at = {}, t0
    for name, t in marks.items():
        phases[name], at = t - at, t
    window = drv.window(seconds)
    trace, traced_info = (drv.traced() if traced else (None, {}))
    dev = device_line(device, trace)
    drv.release()
    checks = judge(drv.check(), cell.limits)
    run = Run(cell, bench, setup_s, window, trace, traced_info)
    metrics = read_metrics(bench, cell.per_layer if traced else cell.end_to_end, run)
    attempted = window.get("requests", window.get("steps", 0))
    line = {"correct": all(passed(c) for c in checks), "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": dev}
    if trace is not None:
        line["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    line["setup_phases"] = phases
    line["checks"] = {c.pop("name"): c for c in checks}
    return line
