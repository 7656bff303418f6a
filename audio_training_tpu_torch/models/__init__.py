"""Every model family of the JAX package and the ``build_model`` registry
(the JAX ``models/__init__.py`` names, plus the port's
``BackboneClassifier`` and ``MobileNetV2``)."""

from audio_training_tpu_torch.models.backbones import MobileNetV2
from audio_training_tpu_torch.models.badwinner import BadWinner
from audio_training_tpu_torch.models.badwinner2 import BadWinner2, BadWinner2Res
from audio_training_tpu_torch.models.layers import (
    LMELayer,
    MagTransform,
    PCENLayer,
    logmeanexp,
)
from audio_training_tpu_torch.models.registry import (
    MODEL_NAMES,
    BackboneClassifier,
    ModelSpec,
    build_model,
    build_random_forest,
    fold_gray_stem,
)
from audio_training_tpu_torch.models.wr_resnet import WRResNet
from audio_training_tpu_torch.models.wr_resnet_bird import WRResNetBird

__all__ = [
    "BadWinner",
    "BadWinner2",
    "BadWinner2Res",
    "WRResNet",
    "WRResNetBird",
    "MagTransform",
    "PCENLayer",
    "LMELayer",
    "logmeanexp",
    "ModelSpec",
    "build_model",
    "build_random_forest",
    "fold_gray_stem",
    "MODEL_NAMES",
    "BackboneClassifier",
    "MobileNetV2",
]
