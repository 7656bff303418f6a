"""The PyTorch port imports nothing of JAX, Flax or the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_training_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_modules_import_without_jax():
    """In a fresh interpreter, importing every port module leaves jax, flax
    and every audio_training_tpu.* module out of sys.modules."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import audio_training_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'modules': sorted(sys.modules)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, check=True,
        capture_output=True, text=True,
    ).stdout
    result = json.loads(out.strip().splitlines()[-1])
    for name in ("ops.cuda.fused_featurizer", "ops.cuda.melspec",
                 "infer.fused", "infer.predictor", "cli.predict",
                 "detect.signals", "corpus.audioio", "train.checkpoints",
                 "data.preprocess", "train.losses", "train.metrics",
                 "train.state", "train.step", "train.loop",
                 "models.backbones", "models.registry", "models.convert",
                 "models.badwinner2", "probes.probe_megakernel",
                 "ops.cuda.ablate", "taxonomy.ebird", "taxonomy.ontology",
                 "taxonomy.labels", "data.example", "data._native",
                 "data.tfrecord", "data.schema", "data.pipeline",
                 "data.parallel_loader", "eval.confusion",
                 "utils.tensorboard", "train.metadata", "train.harness",
                 "cli.train"):
        assert f"audio_training_tpu_torch.{name}" in result["imported"]
    leaked = [m for m in result["modules"] if _forbidden(m)]
    assert not leaked, leaked


def test_port_sources_and_chip_smoke_name_no_jax_import():
    """No import statement in the port or in chip_smoke.py names jax,
    flax or the JAX package (the subprocess test sees only what runs)."""
    files = sorted((REPO / "audio_training_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            bad += [(path.name, n) for n in names if _forbidden(n)]
    assert len(files) > 10
    assert not bad, bad
