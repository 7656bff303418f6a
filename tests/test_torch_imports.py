"""The PyTorch port imports nothing of JAX, Flax or the JAX package, nor
scikit-learn, TensorFlow or orbax; matplotlib only inside the functions
that plot, and h5py, filelock and requests only inside the corpus tools'
functions that use them."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_training_tpu")
# packages the card's image lacks: never imported; matplotlib, and the
# corpus tools' h5py, filelock and requests, only lazily
ABSENT = ("sklearn", "tensorflow", "orbax", "matplotlib", "h5py", "filelock",
          "requests")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_modules_import_without_jax():
    """In a fresh interpreter, importing every port module leaves jax, flax,
    every audio_training_tpu.* module, scikit-learn, TensorFlow, orbax,
    matplotlib, h5py, filelock and requests out of sys.modules."""
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
                 "cli.train", "ops.denoise", "corpus.dataset", "eval.prep",
                 "eval.strong", "eval.weak", "eval.thresholds",
                 "eval.compare", "eval.plots", "infer.freeze",
                 "infer.ebirdgrid", "infer.folder", "cli.evaluate",
                 "cli.freeze", "cli.ebirdgrid", "models.badwinner",
                 "models.wr_resnet", "models.wr_resnet_bird",
                 "models.resnet", "models.layers", "data.embeddings",
                 "corpus.split", "corpus.writer", "corpus.features",
                 "corpus.signal_data", "cli.build", "corpus.enrich",
                 "corpus.otherdata", "corpus.tools", "corpus.downloaders",
                 "cli.ingest", "utils.logging", "utils.debug", "cli.debug",
                 "data.augmented", "cli.augment", "utils.profiling"):
        assert f"audio_training_tpu_torch.{name}" in result["imported"]
    leaked = [m for m in result["modules"]
              if _forbidden(m) or m.split(".")[0] in ABSENT]
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


def test_port_names_absent_packages_only_inside_functions():
    """No import of TensorFlow or orbax anywhere in the port; matplotlib,
    h5py, filelock and requests only inside a function body; scikit-learn
    only inside ``models/registry.build_random_forest`` (``rf-features``'
    forest, as in the JAX package)."""
    bad = []
    for path in sorted((REPO / "audio_training_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        in_forest = {id(n) for f in ast.walk(tree)
                     if isinstance(f, ast.FunctionDef)
                     and f.name == "build_random_forest"
                     and path.name == "registry.py"
                     for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                allowed = {"matplotlib": inside, "sklearn": in_forest,
                           "h5py": inside, "filelock": inside,
                           "requests": inside}
                if top in ABSENT and id(node) not in allowed.get(top, ()):
                    bad.append((path.name, n))
    assert not bad, bad
