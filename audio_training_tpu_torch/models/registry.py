"""Model registry — the ``build_model`` dispatch (port of
``audio_training_tpu/models/registry.py:151-330``).  Ported: ``badwinner2``
and the backbone classifier around ``mobilenet``; every other name raises
``NotImplementedError`` naming the ROADMAP item that ports it."""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from audio_training_tpu_torch.models.backbones import BACKBONES
from audio_training_tpu_torch.models.badwinner2 import BadWinner2
from audio_training_tpu_torch.models.layers import (
    LMELayer,
    MagTransform,
    PCENLayer,
    global_avg_pool,
    lecun_normal_,
)

_FAMILIES_ITEM = 'ROADMAP.md queue 1, "Model families"'


@dataclass(frozen=True)
class ModelSpec:
    """What inputs a model takes; used by the train/infer harness."""

    module: nn.Module
    inputs: tuple[str, ...]  # e.g. ("mel",)


class BackboneClassifier(nn.Module):
    """Pretrained-backbone adapter (JAX ``registry.py:151-194``,
    audiomodel.py:784-820): PCEN (or MagTransform) frontend -> backbone ->
    optional LME -> global average pool in the compute dtype, then f32 ->
    Dropout -> f32 Dense -> sigmoid / softmax / logits.

    The input is NHWC ``(B, mel, frames, C)`` as in the JAX package; the
    frontend runs on it (PCEN's time axis is 2), the backbone on its NCHW
    view.  ``external_frontend=True`` takes an image that is already
    PCEN'd (the fused featurizer's epilogue) and builds no frontend.
    ``.train()`` is Flax's ``train=True``: BatchNorm on batch moments and
    dropout drawn from the ``generator`` given to ``forward``.  Module
    names map onto the Flax tree (``models/convert.py``)."""

    def __init__(
        self,
        backbone_name: str,
        num_labels: int,
        in_channels: int = 3,
        multi_label: bool = True,
        lme: bool = False,
        use_pcen: bool = True,
        dropout: float = 0.5,
        logits_only: bool = False,
        external_frontend: bool = False,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.multi_label = multi_label
        self.logits_only = logits_only
        self.dropout = dropout
        self.pcen = self.mag = None
        if not external_frontend:
            if use_pcen:
                self.pcen = PCENLayer(time_axis=2)
            else:
                self.mag = MagTransform()
        self.backbone = BACKBONES[backbone_name](
            in_channels, dtype=dtype, generator=generator)
        self.lme = (nn.Sequential(LMELayer(dim=2, sharpness=5),
                                  LMELayer(dim=3, sharpness=5))
                    if lme else None)
        self.dense = nn.Linear(1280, num_labels)
        with torch.no_grad():
            lecun_normal_(self.dense.weight, generator=generator)
            self.dense.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, mel, frames, C) -> (B, num_labels) f32."""
        if self.pcen is not None:
            x = self.pcen(x)
        elif self.mag is not None:
            x = self.mag(x)
        x = self.backbone(x.permute(0, 3, 1, 2))
        if self.lme is not None:
            x = self.lme(x)
        x = global_avg_pool(x).float()
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.empty(x.shape, device=x.device).bernoulli_(
                keep, generator=generator)
            x = torch.where(mask.bool(), x / keep, torch.zeros_like(x))
        x = self.dense(x)
        if self.logits_only:
            return x
        return torch.sigmoid(x) if self.multi_label else torch.softmax(x, -1)


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
    ``in_channels``, ``dropout``, ``external_frontend``, ``generator``; for
    a backbone: ``in_channels``,
    ``use_pcen``, ``dropout``, ``external_frontend``, ``generator``)."""
    name = model_name.lower()
    common = dict(multi_label=multi_label, lme=lme, logits_only=logits_only,
                  dtype=dtype)
    if name == "badwinner2":
        return ModelSpec(BadWinner2(num_labels, **common, **kwargs), ("mel",))
    if name in BACKBONES:
        return ModelSpec(
            BackboneClassifier(name, num_labels, **common, **kwargs),
            ("mel",))
    raise NotImplementedError(
        f"model {model_name!r} is not ported yet: {_FAMILIES_ITEM}")


def fold_gray_stem(model: BackboneClassifier) -> BackboneClassifier:
    """Exact-math serving fold (JAX ``registry.py:272-330``): a copy of
    ``model`` whose one 3-input-channel conv kernel (the stem) is summed
    over its input channels, so that it takes the 1-channel mel image that
    the reference repeats to 3 channels (tfdataset.py:175-180):
    ``conv(repeat(x, 3), W) == conv(x, W.sum(1))``.  The ported backbone
    applies no per-channel preprocessing before its stem, so the fold
    always holds for it."""
    if not isinstance(model, BackboneClassifier):
        raise ValueError("fold_gray_stem only applies to BackboneClassifier")
    folded = copy.deepcopy(model)
    stems = [m for m in folded.modules()
             if getattr(m, "weight", None) is not None
             and m.weight.ndim == 4 and m.weight.shape[1] == 3]
    if len(stems) != 1:
        raise ValueError(
            f"expected exactly one 3-input-channel conv kernel (the stem), "
            f"found {len(stems)}")
    stem = stems[0]
    stem.weight = nn.Parameter(stem.weight.detach().sum(1, keepdim=True))
    return folded
