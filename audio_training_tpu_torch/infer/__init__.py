"""Inference entry points."""

from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
from audio_training_tpu_torch.infer.predictor import (
    ModelResult,
    Predictor,
    aggregate_tracks,
)
from audio_training_tpu_torch.infer.windows import (
    WindowBatch,
    bucket_pad,
    extract_track_windows,
)

__all__ = [
    "make_fused_infer_fn",
    "Predictor",
    "ModelResult",
    "aggregate_tracks",
    "extract_track_windows",
    "WindowBatch",
    "bucket_pad",
]
