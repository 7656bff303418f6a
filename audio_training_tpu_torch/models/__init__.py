"""Model families ported so far and the ``build_model`` registry."""

from audio_training_tpu_torch.models.backbones import MobileNetV2
from audio_training_tpu_torch.models.badwinner2 import BadWinner2
from audio_training_tpu_torch.models.registry import (
    BackboneClassifier,
    ModelSpec,
    build_model,
    fold_gray_stem,
)

__all__ = ["BackboneClassifier", "BadWinner2", "MobileNetV2", "ModelSpec",
           "build_model", "fold_gray_stem"]
