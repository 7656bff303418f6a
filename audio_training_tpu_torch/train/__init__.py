"""Training (port of ``audio_training_tpu/train``): state, steps, losses,
metrics, checkpoints and the ``fit`` loop, and what inference reads of a
run directory (its metadata and the port's weights file)."""

from audio_training_tpu_torch.train.checkpoints import (
    BestCheckpointTracker,
    load_state_dict,
    restore_into,
    restore_with_new_head,
    save_state,
)
from audio_training_tpu_torch.train.loop import (
    EarlyStopping,
    FitResult,
    ReduceLROnPlateau,
    fit,
)
from audio_training_tpu_torch.train.losses import get_loss
from audio_training_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    param_count,
)
from audio_training_tpu_torch.train.step import (
    fresh_metrics,
    make_eval_step,
    make_predict_fn,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "param_count",
    "make_train_step",
    "make_eval_step",
    "make_predict_fn",
    "fresh_metrics",
    "fit",
    "FitResult",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "get_loss",
    "save_state",
    "load_state_dict",
    "restore_into",
    "restore_with_new_head",
    "BestCheckpointTracker",
]
