"""The port's weights file: a model's ``state_dict`` saved with
``torch.save`` and read back with ``torch.load(weights_only=True)``.

The JAX package checkpoints with orbax (``audio_training_tpu/train/
checkpoints.py``), which cannot be read without JAX; reading those
directories is queued in ROADMAP.md.  Until then a JAX run's weights reach
the port through ``models.convert`` (Flax variables -> ``state_dict``) and
this file.
"""

from __future__ import annotations

from pathlib import Path

import torch

SUFFIX = ".pt"


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
