"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files cut to a size the CPU runs in seconds (0.75 s clips, 4 clips a
batch), and the card, for the tests marked ``gpu``.

Run from the root of the repository:

    python3 -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from portbench.cell import ROOT

CLIP_SECONDS = 0.75
BATCH = 4


def tiny_copy(dst, dtype: str | None = None):
    """``configs/``, ``workloads/`` and ``metrics/`` of the benchmark in
    ``dst``, cut to the tiny size; ``dtype`` overrides the models' and the
    serving featurizer's output dtype."""
    for kind in ("configs", "workloads"):
        (dst / kind).mkdir(parents=True)
        for f in sorted((ROOT / kind).glob("*.json")):
            j = json.loads(f.read_text())
            if kind == "configs":
                j["geometry"]["clip_seconds"] = CLIP_SECONDS
                j["calibrate_rows"] = BATCH
                if dtype:
                    j["model"]["dtype"] = dtype
            else:
                j["traffic"]["batch"] = BATCH
                if dtype and "entry" in j["traffic"]:
                    j["traffic"]["entry"]["out_dtype"] = dtype
            (dst / kind / f.name).write_text(json.dumps(j))
    shutil.copytree(ROOT / "metrics", dst / "metrics")
    return dst


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(2)
    return tiny_copy(tmp_path / "tiny")


@pytest.fixture
def tiny_f32(tmp_path):
    torch.set_num_threads(2)
    return tiny_copy(tmp_path / "tiny", dtype="float32")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
