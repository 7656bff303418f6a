"""The port's weights file, and training checkpoints built on it (port of
``audio_training_tpu/train/checkpoints.py:23-138``).

A weights file is a model's ``state_dict`` (parameters and BatchNorm
running statistics) saved with ``torch.save`` and read back with
``torch.load(weights_only=True)``; ``cli/predict.py`` reads it.  Training
writes one per tracked validation metric (``val-loss.pt``, ...), plus the
unconditional per-epoch ``chkpt.pt`` and ``best.json`` — the Keras
callback suite of the reference (audiomodel.checkpoints,
audiomodel.py:878-950).  Like the JAX package's checkpoints, they hold no
optimizer state.

The JAX package checkpoints with orbax, and ``import orbax.checkpoint``
loads JAX, which the port never imports: the port does not read those
directories.  A JAX run's weights reach the port through ``models.convert``
(Flax variables -> ``state_dict``, in a process that has JAX) and this
file.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)

SUFFIX = ".pt"

# metric name -> maximize? (audiomodel.py:878-907)
TRACKED_METRICS = {
    "val_loss": False,
    "val_precision": True,
    "val_auc": True,
    "val_recall": True,
    "val_huber": False,
    "val_focal": False,
    "val_accuracy": True,
}


def save_state_dict(path: str | Path, state_dict: dict) -> Path:
    """Write ``state_dict`` (tensors or arrays) to ``path`` on the CPU."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.as_tensor(v).detach().cpu()
                for k, v in state_dict.items()}, path)
    return path


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a file written by :func:`save_state_dict` (tensors only: the
    loader unpickles no other objects)."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def save_state(path: str | Path, state) -> Path:
    """A train state's model weights to ``path`` (a ``.pt`` file)."""
    return save_state_dict(path, state.model.state_dict())


def restore_into(state, path: str | Path):
    """Load a weights file into the state's model (optimizer untouched)."""
    state.model.load_state_dict(load_state_dict(path))
    return state


def restore_with_new_head(state, path: str | Path):
    """Fine-tune restore that keeps the fresh tensor wherever the file's
    shape disagrees or the file has none — the head swap when label counts
    differ (audiomodel.py:835-857); BatchNorm statistics merge the same
    way."""
    payload = load_state_dict(path)
    own = state.model.state_dict()
    kept_fresh = [k for k, v in own.items()
                  if k not in payload or payload[k].shape != v.shape]
    if kept_fresh:
        log.info("kept fresh (shape-mismatched) tensors: %s", kept_fresh)
    state.model.load_state_dict(
        {k: own[k] if k in kept_fresh else payload[k] for k in own})
    return state


@dataclass
class BestCheckpointTracker:
    """Tracks per-metric bests and saves a weights file per metric."""

    run_dir: Path
    metrics: dict = field(default_factory=lambda: dict(TRACKED_METRICS))
    best: dict = field(default_factory=dict)

    def update(self, epoch: int, logs: dict[str, float], state) -> list[str]:
        saved = []
        for name, maximize in self.metrics.items():
            if name not in logs or not np.isfinite(logs[name]):
                continue
            cur = logs[name]
            prev = self.best.get(name)
            if prev is None or (cur > prev if maximize else cur < prev):
                self.best[name] = cur
                save_state(self.run_dir / f"{name.replace('val_', 'val-')}"
                           f"{SUFFIX}", state)
                saved.append(name)
        # unconditional per-epoch checkpoint (chkpt.weights.h5 parity)
        save_state(self.run_dir / f"chkpt{SUFFIX}", state)
        (self.run_dir / "best.json").write_text(json.dumps(self.best, indent=2))
        if saved:
            log.info("epoch %s: improved %s", epoch, saved)
        return saved
