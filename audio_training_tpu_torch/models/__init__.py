"""Model families ported so far and the ``build_model`` registry."""

from audio_training_tpu_torch.models.badwinner2 import BadWinner2
from audio_training_tpu_torch.models.registry import ModelSpec, build_model

__all__ = ["BadWinner2", "ModelSpec", "build_model"]
