"""A configuration, a cell and a per-layer metric added as new files and
new entries alone, with no edit to a file the benchmark has."""

from __future__ import annotations

import json

from portbench import run
from portbench.cell import load_cell
from portbench.trace import UNIT, Op, Span, TraceView

ARGS = ["--seed", "77", "--seconds", "1", "--trace", "0"]


def test_new_configuration_cell_and_metric_as_files(tiny_f32, capsys):
    root = tiny_f32
    config = json.loads((root / "configs" / "badwinner2.json").read_text())
    config["name"] = "badwinner2-96"
    config["geometry"]["n_mels"] = 96
    (root / "configs" / "badwinner2-96.json").write_text(json.dumps(config))
    workload = json.loads(
        (root / "workloads" / "badwinner2.serve-b256.json").read_text())
    workload["config"] = "badwinner2-96"
    (root / "workloads" / "badwinner2-96.serve-b4.json").write_text(
        json.dumps(workload))
    (root / "metrics" / "units.serve.py").write_text(
        "def read(view):\n    return float(view.units)\n")

    bench = json.loads((run.REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "badwinner2-96.serve-b4",
                               "config": "badwinner2-96", "traffic":
                               "serve-b4", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "badwinner2.serve-b256" in m["workloads"]:
            m["workloads"].append("badwinner2-96.serve-b4")
    bench["per_layer"].append({
        "name": "units.serve", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "serve_audio_s_per_s",
        "workloads": ["badwinner2-96.serve-b4"]})
    bench_path = root / "BENCHMARK.json"
    bench_path.write_text(json.dumps(bench))

    cell = load_cell("badwinner2-96.serve-b4", 1, 1.0, False, "cpu", root)
    assert cell.geometry["n_mels"] == 96
    e2e, layer = run.cell_metrics(bench, cell.name)
    assert [m["name"] for m in layer] == ["units.serve"]
    view = TraceView([Op("k", 0, 1, None)], [Span(UNIT, 0, 2)], 3, "serve")
    assert run.reader("units.serve", root)(view) == 3.0

    assert run.main(["--workload", cell.name, *ARGS], device="cpu",
                    root=root, bench_path=bench_path) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["checks"]) == {"logit_rms_gap", "logit_max_gap"}
    assert set(line["metrics"]) == {m["name"] for m in e2e}
