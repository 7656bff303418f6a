"""A cell, found by name: its workload file (``workloads/<cell>.json``),
the configuration it names (``configs/<config>.json``), the seed, the
window and whether it is traced; and the pieces every loop builds from
them (seeds, weights, the pool, the program's model).

A loop is ``loops/<traffic["loop"]>.py``; nothing here or in the
runner branches on a cell or a model.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import traffic, weights
from portbench.counts.k1 import clip_samples, frames
from portbench.reference import model as reference_model
from portbench.reference.featurizer import MelReference, image

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    hooks: dict = field(default_factory=dict)  # faults, for the checks
    marks: list = field(default_factory=list)  # (set-up stage, boot clock)

    def mark(self, stage: str) -> None:
        from portbench.window import boot_clock

        self.marks.append((stage, boot_clock()))

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    @property
    def geometry(self) -> dict:
        return self.config["geometry"]

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def front(self) -> dict:
        """What the reference does to a batch of clips before its model."""
        return self.traffic["front"]

    def sub_seed(self, tag: str) -> int:
        """A seed for one use (weights, pool, a generator) from the run's
        seed; any whole number works, within 63 bits."""
        digest = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(digest[:8], "little") >> 1

    def loop(self):
        return importlib.import_module(
            f"portbench.loops.{self.traffic['loop']}")


def load_cell(name: str, seed: int, seconds: float, trace: bool, device,
              root: Path = ROOT) -> Cell:
    workload = load("workloads", name, root)
    config = load("configs", workload["config"], root)
    return Cell(name, workload, config, seed, seconds, trace,
                torch.device(device))


@dataclass
class Inputs:
    """What the benchmark makes and hands to both sides: the weights (the
    initial ones for training), the clip pool and its labels."""
    tensors: dict
    clips: torch.Tensor
    labels: torch.Tensor

    def batch(self, cell: Cell, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Pool batch ``i`` (a view)."""
        b = cell.batch
        return self.clips[i * b:(i + 1) * b], self.labels[i * b:(i + 1) * b]


def make_inputs(cell: Cell) -> Inputs:
    """Weights and pool from the seed, on the device; the BatchNorm running
    statistics calibrated on ``calibrate_rows`` clips of the pool."""
    cfg, g = cell.config, cell.geometry
    ref = reference_model(cfg["reference"])
    spec = ref.spec(cfg["num_labels"], g, cell.front.get("channels", 1))
    tensors = weights.make(spec, cell.sub_seed("weights"), cell.device)
    clips, labels = traffic.pool(
        cell.traffic["pool"] * cell.batch, clip_samples(g), g["sr"],
        cfg["num_labels"], cell.sub_seed("pool"), cell.device)
    rows = clips[:cfg["calibrate_rows"]]
    weights.calibrate(ref, tensors, image(
        rows, MelReference(g, cell.device), cell.front))
    return Inputs(tensors, clips, labels)


def featurizer_config(cell: Cell):
    from audio_training_tpu_torch.config import FeaturizerConfig

    g = cell.geometry
    return FeaturizerConfig(
        sr=g["sr"], segment_length=g["clip_seconds"], n_fft=g["n_fft"],
        hop_length=g["hop_length"], n_mels=g["n_mels"],
        break_freq=g["break_freq"], fmin=g["fmin"], fmax=g["fmax"])


def program_model(cell: Cell, tensors: dict) -> torch.nn.Module:
    """The program's model, built by its registry as the configuration
    names it, holding the benchmark's weights."""
    from audio_training_tpu_torch.models.registry import build_model

    m = cell.config["model"]
    with torch.device("meta"):
        module = build_model(
            m["name"], cell.config["num_labels"],
            dtype=getattr(torch, m["dtype"]), n_mels=cell.geometry["n_mels"],
            mel_frames=frames(cell.geometry), **m["kwargs"]).module
    module = module.to_empty(device=cell.device)
    module.load_state_dict(tensors, strict=True)
    return module


def free_program() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
