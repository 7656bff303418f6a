"""Inference entry points."""

from audio_training_tpu_torch.infer.ebirdgrid import (
    apply_species_mask,
    build_species_grid,
    merge_neighbours,
    species_at,
)
from audio_training_tpu_torch.infer.freeze import format_metadata, freeze
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
    "build_species_grid",
    "apply_species_mask",
    "species_at",
    "merge_neighbours",
    "freeze",
    "format_metadata",
]
