"""BENCHMARK.json against the contract's limits, and the harness finding
a new configuration, traffic mix and per-layer metric by name alone."""

import json
import re

import pytest

from benchmark.registry import Bench
from conftest import ROOT, tiny_spec_and_files

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_configs_cells_and_bounds():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and cfg["reduced"] == c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def cells_reporting(metric):
    return set(metric.get("workloads", [w["name"] for w in SPEC["workloads"]]))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    assert cells_reporting(metric) <= cells_reporting(e2e[metric["moves"]])
    assert "\n" not in metric["layer"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in cells_reporting(m) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(Bench.load(ROOT).reader(metric["name"]))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer metric
    with its layer's name file, dropped in as new files and entries."""
    spec = tiny_spec_and_files(tmp_path)
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "layers" / "new_layer.txt").write_text("# a comment\nsome_kernel\n")
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0 if run.cell.name == 'tiny.train' else None\n")
    spec["per_layer"].append({"name": "new_metric", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "New", "moves": "train_img_s",
                              "workloads": ["tiny.train"]})
    bench = Bench(spec, bench_dir)
    cell = bench.cell("tiny.train")
    assert cell.config["ngf"] == 8 and cell.traffic["steps_per_call"] == 3
    assert cell.limits["change_median_gap"] == 0.5
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert bench.layer_kernels("new_layer") == ["some_kernel"]

    class Run:
        pass

    run = Run()
    run.cell = cell
    assert bench.reader("new_metric")(run) == 42.0
    assert "new_metric" not in [m["name"] for m in bench.cell("tiny.serve").per_layer]


def test_a_missing_file_is_named(tmp_path):
    spec = tiny_spec_and_files(tmp_path)
    (tmp_path / "benchmark" / "traffic" / "tiny_serve.json").unlink()
    with pytest.raises(FileNotFoundError, match="tiny_serve"):
        Bench(spec, tmp_path / "benchmark").cell("tiny.serve")
