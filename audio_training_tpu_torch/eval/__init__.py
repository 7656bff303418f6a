"""Evaluation (port of ``audio_training_tpu/eval``): so far the confusion
tooling; the rest comes with ROADMAP.md's "Evaluation, deployment and the
rest of long-recording inference"."""

from audio_training_tpu_torch.eval.confusion import (
    confusion_matrix,
    display_labels,
    load_raw_predictions,
    mean_model_confusion,
    multi_label_confusion,
    plot_confusion_matrix,
    save_confusion,
    save_raw_predictions,
    single_label_confusion,
)

__all__ = [
    "confusion_matrix",
    "display_labels",
    "single_label_confusion",
    "multi_label_confusion",
    "save_confusion",
    "save_raw_predictions",
    "load_raw_predictions",
    "mean_model_confusion",
    "plot_confusion_matrix",
]
