"""Model registry — the ``build_model`` dispatch (port of
``audio_training_tpu/models/registry.py:197-220``).  Only ``badwinner2`` is
ported; every other name raises ``NotImplementedError`` naming the ROADMAP
item that ports it."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from audio_training_tpu_torch.models.badwinner2 import BadWinner2

_BACKBONE_ITEM = "ROADMAP.md queue item 2 (PCEN -> MobileNetV2)"
_FAMILIES_ITEM = "ROADMAP.md queue item 5 (remaining model families)"


@dataclass(frozen=True)
class ModelSpec:
    """What inputs a model takes; used by the train/infer harness."""

    module: nn.Module
    inputs: tuple[str, ...]  # e.g. ("mel",)


def build_model(
    model_name: str,
    num_labels: int,
    multi_label: bool = True,
    lme: bool = False,
    logits_only: bool = False,
    dtype: torch.dtype | None = None,
    **kwargs,
) -> ModelSpec:
    """Build a model by reference CLI name (audiomodel.py:660-876).
    ``kwargs`` go to the model (for badwinner2: ``n_mels``,
    ``in_channels``, ``generator``)."""
    name = model_name.lower()
    if name == "badwinner2":
        return ModelSpec(
            BadWinner2(num_labels, multi_label=multi_label, lme=lme,
                       logits_only=logits_only, dtype=dtype, **kwargs),
            ("mel",),
        )
    item = _BACKBONE_ITEM if name == "mobilenet" else _FAMILIES_ITEM
    raise NotImplementedError(f"model {model_name!r} is not ported yet: {item}")
