"""BENCHMARK.json against the benchmark's contract and its data files."""

from __future__ import annotations

import json
import re

import pytest

from portbench.cell import ROOT, load, load_cell
from portbench.run import REPO, cell_metrics, reader

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("end_to_end", "per_layer", "configs", "workloads"):
        assert len({m["name"] for m in BENCH[kind]}) == len(BENCH[kind])
    texts = [w["why"] for w in BENCH["workloads"]]
    texts += [c[k] for c in BENCH["configs"] for k in ("why", "source")]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(TEXT.match(t) for t in texts)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, layer = cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


def test_every_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            e2e, layer = cell_metrics(BENCH, cell)
            assert m["moves"] in {e["name"] for e in e2e}
            assert m in layer


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name_in_its_files(w):
    cell = load_cell(w["name"], 1, 1.0, False, "cpu")
    assert cell.workload["config"] == w["config"]
    assert cell.workload["chips"] == w["chips"] == 1
    assert cell.workload["why"] == w["why"]
    assert set(cell.workload["limits"]) and all(
        isinstance(v, float) for v in cell.workload["limits"].values())
    cell.loop()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = load("configs", c["name"])
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(reader(m["name"]))


def test_paths_hold_only_the_benchmark():
    assert (ROOT / "run.py").exists()
    assert not (ROOT.name.endswith("_torch"))
