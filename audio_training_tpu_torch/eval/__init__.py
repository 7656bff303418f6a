"""Evaluation (port of ``audio_training_tpu/eval``): confusion tooling,
A/B compare, per-class thresholds, weak- and strong-label directory
evaluation and plots."""

from audio_training_tpu_torch.eval.compare import (
    CompareResult,
    compare_confusions,
)
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
from audio_training_tpu_torch.eval.thresholds import (
    apply_thresholds,
    best_thresholds,
    combine_pre_model,
    reference_shipped_thresholds,
    reference_shipped_thresholds_dict,
)
from audio_training_tpu_torch.eval.weak import (
    WeakEvalResult,
    evaluate_weakly_labelled_dir,
)

__all__ = [
    "confusion_matrix",
    "single_label_confusion",
    "multi_label_confusion",
    "save_confusion",
    "save_raw_predictions",
    "load_raw_predictions",
    "mean_model_confusion",
    "plot_confusion_matrix",
    "display_labels",
    "compare_confusions",
    "CompareResult",
    "best_thresholds",
    "apply_thresholds",
    "reference_shipped_thresholds",
    "reference_shipped_thresholds_dict",
    "combine_pre_model",
    "evaluate_weakly_labelled_dir",
    "WeakEvalResult",
]
