"""Training (port of ``audio_training_tpu/train``): state, steps, losses,
metrics, checkpoints, the ``fit`` loop, the run harness that trains from a
built corpus (``train_run``), and a run directory's metadata."""

from audio_training_tpu_torch.train.checkpoints import (
    BestCheckpointTracker,
    load_state_dict,
    restore_into,
    restore_with_new_head,
    save_state,
)
from audio_training_tpu_torch.train.harness import (
    TrainRunResult,
    cross_fold_train,
    init_labels,
    train_run,
)
from audio_training_tpu_torch.train.loop import (
    EarlyStopping,
    FitResult,
    ReduceLROnPlateau,
    fit,
)
from audio_training_tpu_torch.train.losses import get_loss
from audio_training_tpu_torch.train.metadata import (
    featurizer_from_metadata,
    load_metadata,
    save_metadata,
)
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
    "load_metadata",
    "featurizer_from_metadata",
    "save_metadata",
    "train_run",
    "init_labels",
    "cross_fold_train",
    "TrainRunResult",
]
