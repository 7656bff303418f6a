"""The runner end to end on the CPU at the tiny size, its refusal without
a card, and what it imports."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.calibrate import FAULTS
from portbench.cell import ROOT

ARGS = ["--seed", "3000000019", "--seconds", "1", "--trace", "0"]
CELLS = ["badwinner2.train-b128", "badwinner2.serve-b256"]


def result(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_exits_without_a_card_and_prints_no_result():
    """Where torch finds no CUDA card (a machine without one), the run exits 2 and
    prints nothing on standard output; on a card the test has nothing to
    show."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[1],
         *ARGS], cwd=run.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_cpu_prints_the_result_line(tiny_f32, capsys, cell):
    assert run.main(["--workload", cell, *ARGS], device="cpu",
                    root=tiny_f32) == 0
    line = result(capsys)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(tiny_f32, capsys, fault):
    """The run with one fault planted under the timed path: its cell reads
    ``correct`` false."""
    hooks = FAULTS[fault]
    cell = CELLS[0] if "wrap_step" in hooks else CELLS[1]
    assert run.main(["--workload", cell, *ARGS], device="cpu",
                    root=tiny_f32, hooks=hooks) == 0
    assert result(capsys)["correct"] is False


def test_the_runner_loads_no_jax():
    """A whole run in a fresh process, then the check the runner makes."""
    code = ("import sys, torch, pathlib, tempfile\n"
            "sys.path.insert(0, 'portbench/tests')\n"
            "from conftest import tiny_copy\n"
            "from portbench import run\n"
            "root = tiny_copy(pathlib.Path(tempfile.mkdtemp()) / 't', "
            "'float32')\n"
            f"rc = run.main(['--workload', '{CELLS[1]}', *{ARGS!r}], "
            "device='cpu', root=root)\n"
            "print('FORBIDDEN', run.forbidden_modules(), rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.REPO,
                          capture_output=True, text=True, timeout=600)
    assert "FORBIDDEN [] 0" in proc.stdout, proc.stderr[-2000:]


def imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    for path in ROOT.rglob("*.py"):
        assert not imports(path) & {"jax", "jaxlib", "flax",
                                    "audio_training_tpu"}, path
    for path in (ROOT / "reference").rglob("*.py"):
        assert "audio_training_tpu_torch" not in imports(path), path
    for path in (ROOT / "counts").rglob("*.py"):
        assert "audio_training_tpu_torch" not in imports(path), path
