"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  It makes
the weights and the clip pool on the card from the seed, warms up the
cell's shapes, measures for ``--seconds``, checks the answers against the
plain reference (``portbench/reference/``) and prints one JSON line last:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
(read from a ``torch.profiler`` window) with ``--trace 1``.  Each number
compared is printed beside its limit as the last lines of standard error
and under ``checks``, the line's last key.

It exits with 2 and prints no result where ``torch.cuda`` finds fewer
cards than the cell needs, and with 3 where the process has loaded JAX or
the JAX package.  Everything it builds (the program's kernels, under
``build/``) stays inside the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from portbench import window
from portbench.cell import load, load_cell
from portbench.compare import passed

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_training_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) entries of ``bench`` that ``cell`` reports."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if (
        cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return (f"card: {out[0] if out else 'nvidia-smi gave nothing'}; peaks "
            "989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s (H100 SXM, 700 W)")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", root: Path = ROOT,
         bench_path: Path = REPO / "BENCHMARK.json",
         hooks: dict | None = None) -> int:
    args = parse(argv)
    chips = load("workloads", args.workload, root)["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                     device, root)
    cell.hooks = hooks or {}
    out = cell.loop().run(cell)
    w = out["window"]
    start = window.process_start()
    setup_s = w.started - start
    bench = json.loads(bench_path.read_text())
    e2e, layer = cell_metrics(bench, cell.name)
    metrics = {}
    if not cell.trace:
        values = {**out["end_to_end"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    found = forbidden_modules()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    on_card = cell.device.type == "cuda"
    result = {
        "correct": out["failed"] == 0 and passed(out["checks"]),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(cell.device) if on_card
            else "cpu",
            "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if cell.trace and w.view is not None:
        view = w.view
        view.context["window_peak_bytes"] = out["window_peak_bytes"]
        for m in layer:
            value = reader(m["name"], root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = view.busy_s()
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out["checks"]}
    if on_card:
        print(card_line(), file=sys.stderr)
    stages, at = [], start
    for stage, t in [*cell.marks, ("warm-up", w.started)]:
        stages.append(f"{stage} {t - at:.3f} s")
        at = t
    print(f"window {w.seconds:.3f} s, {w.units} units; reference "
          f"{out['reference_s']:.3f} s; setup {setup_s:.3f} s: "
          + ", ".join(stages), file=sys.stderr)
    for n, v, lim in out["checks"]:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
