"""Training loop (port of ``audio_training_tpu/train/loop.py:27-333``) —
replaces Keras ``model.fit`` + callback suite (audiomodel.train_model,
audiomodel.py:405-567): per-epoch train/val passes, best-per-metric
checkpoints, early stopping (patience 10), reduce-LR-on-plateau, the
per-epoch ``training-log.csv``, the TensorBoard event file, the
``hist_writer`` hook, the per-epoch validation confusion, ``history.json``,
and the rollback of an epoch whose loss is not finite.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from audio_training_tpu_torch.eval.confusion import (
    multi_label_confusion,
    save_confusion,
    single_label_confusion,
)
from audio_training_tpu_torch.train.checkpoints import (
    SUFFIX,
    BestCheckpointTracker,
    restore_into,
)
from audio_training_tpu_torch.train.metrics import metrics_compute, metrics_init
from audio_training_tpu_torch.train.state import TrainState
from audio_training_tpu_torch.train.step import (
    make_eval_step,
    make_predict_fn,
    make_train_step,
)
from audio_training_tpu_torch.utils.tensorboard import TBEventWriter

log = logging.getLogger(__name__)


@dataclass
class EarlyStopping:
    """Keras EarlyStopping(patience=10) on val_loss (audiomodel.py:908-912)."""

    patience: int = 10
    monitor: str = "val_loss"
    best: float = float("inf")
    wait: int = 0

    def update(self, logs: dict) -> bool:
        cur = logs.get(self.monitor)
        if cur is None or not np.isfinite(cur):
            return False
        if cur < self.best:
            self.best = cur
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience


@dataclass
class ReduceLROnPlateau:
    """Keras ReduceLROnPlateau equivalent (audiomodel.py:913-921)."""

    patience: int = 5
    factor: float = 0.5
    min_lr: float = 1e-6
    monitor: str = "val_loss"
    best: float = float("inf")
    wait: int = 0

    def update(self, logs: dict, state: TrainState) -> TrainState:
        cur = logs.get(self.monitor)
        if cur is None or not np.isfinite(cur):
            return state
        if cur < self.best:
            self.best = cur
            self.wait = 0
            return state
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            new_lr = max(state.current_lr() * self.factor, self.min_lr)
            log.info("reducing lr to %s", new_lr)
            state = state.with_lr(new_lr)
        return state


def _write_epoch_confusion(out_dir: Path, epoch: int, y_true, y_pred,
                           labels: list[str], multi_label: bool) -> Path:
    """Per-epoch validation confusion artifact (npy + PNG), the equivalent
    of the reference's TensorBoard confusion image callback
    (audiomodel.log_confusion_matrix, audiomodel.py:1262-1314).  Returns the
    artifact base path (suffix-less) so the caller can stream the PNG into
    the TensorBoard event file too."""
    if multi_label:
        cm, _, out_labels = multi_label_confusion(y_true, y_pred, labels)
    else:
        cm, out_labels = single_label_confusion(y_true, y_pred, labels)
    base = out_dir / f"epoch_{epoch:03d}"
    save_confusion(cm, out_labels, base)
    return base


class ScalarLog:
    """Streaming per-epoch scalar log: one CSV row appended per epoch, so a
    run can be watched mid-fit.  Columns are fixed by the first epoch's
    keys; keys appearing later are ignored."""

    def __init__(self, path: Path):
        self.path = path
        self.header: list[str] | None = None

    def append(self, epoch: int, logs: dict) -> None:
        if self.header is None:
            self.header = ["epoch"] + sorted(logs)
            self.path.write_text(",".join(self.header) + "\n")
        row = [str(epoch)] + [
            repr(float(logs[k])) if k in logs else "" for k in self.header[1:]
        ]
        with self.path.open("a") as f:
            f.write(",".join(row) + "\n")


@dataclass
class FitResult:
    state: TrainState
    history: dict[str, list]
    epochs_run: int


def fit(
    state: TrainState,
    train_batches: Callable[[int], Iterable],
    preprocess,
    epochs: int = 100,
    steps_per_epoch: int | None = None,
    val_batches: Callable[[], Iterable] | None = None,
    val_preprocess=None,
    loss_name: str = "bce",
    multi_label: bool = True,
    label_smoothing: float = 0.0,
    class_weights=None,
    run_dir: str | Path | None = None,
    early_stop_patience: int = 10,
    reduce_lr_patience: int = 5,
    reduce_lr_factor: float = 0.5,
    seed: int = 0,
    augment: bool = True,
    hist_writer=None,
    remat: bool = False,
    bird_index: int | None = None,
    specific_bird_mask=None,
    geo_masks=None,
    confusion_labels: list[str] | None = None,
) -> FitResult:
    """Run the training schedule.

    ``train_batches(epoch)`` yields host batch tuples ``(raw, y[, raw2,
    y2][, latlng])`` (mixup partner and GPS optional); ``preprocess`` is
    :func:`audio_training_tpu_torch.data.preprocess.make_preprocess_fn`'s
    map.  The mixup and dropout draws come from two generators on the
    model's device, seeded from ``seed``.

    With ``run_dir`` set, each epoch's scalars also go to an
    ``events.out.tfevents.*`` file there (``utils/tensorboard.py``), and
    ``hist_writer(epoch, logs, state, tb)`` runs after each epoch with that
    writer.  With ``confusion_labels`` set (and a val stream + run_dir), a
    validation confusion matrix is written per epoch to
    ``run_dir/epoch-confusion/epoch_NNN.{npy,png}`` — the per-epoch
    TensorBoard confusion image of the reference
    (audiomodel.log_confusion_matrix, audiomodel.py:1262-1314)."""
    train_step = make_train_step(
        loss_name=loss_name, multi_label=multi_label,
        label_smoothing=label_smoothing, class_weights=class_weights,
        remat=remat, bird_index=bird_index,
        specific_bird_mask=specific_bird_mask, geo_masks=geo_masks,
    )
    eval_step = make_eval_step(
        loss_name=loss_name, multi_label=multi_label, bird_index=bird_index,
        specific_bird_mask=specific_bird_mask, geo_masks=geo_masks,
    )
    val_preprocess = val_preprocess or preprocess
    run_dir = Path(run_dir) if run_dir is not None else None
    if run_dir is not None:
        run_dir.mkdir(parents=True, exist_ok=True)
    tracker = BestCheckpointTracker(run_dir) if run_dir is not None else None
    scalar_log = (ScalarLog(run_dir / "training-log.csv")
                  if run_dir is not None else None)
    stopper = EarlyStopping(patience=early_stop_patience)
    reducer = ReduceLROnPlateau(patience=reduce_lr_patience,
                                factor=reduce_lr_factor)
    # the standard-dashboard event stream beside training-log.csv
    # (audiomodel.py:553-558): ``tensorboard --logdir`` watches the run live
    tb = TBEventWriter(run_dir) if run_dir is not None else None
    collect_confusion = confusion_labels is not None and run_dir is not None
    confusion_predict = make_predict_fn(multi_label=multi_label)
    device = state.device
    gen_pre = torch.Generator(device=device).manual_seed(seed)
    gen_drop = torch.Generator(device=device).manual_seed(seed + 1)
    history: dict[str, list] = {}
    nan_epochs = 0

    epoch = 0
    for epoch in range(epochs):
        t0 = time.time()
        metrics = metrics_init(device)
        n_steps = 0
        for batch in train_batches(epoch):
            latlng = None
            if len(batch) % 2 == 1:  # GPS rides last (pipeline.BatchLoader)
                latlng, batch = batch[-1], batch[:-1]
            if augment and len(batch) == 4:
                mel, yy = preprocess(*batch, gen_pre)
            else:
                mel, yy = preprocess(*batch[:2])
            state, metrics = train_step(state, metrics, mel, yy, gen_drop,
                                        latlng=latlng)
            n_steps += 1
            if steps_per_epoch is not None and n_steps >= steps_per_epoch:
                break
        logs = metrics_compute(metrics)

        if val_batches is not None:
            y_true_parts, y_pred_parts = [], []
            vmetrics = metrics_init(device)
            for batch in val_batches():
                latlng = batch[-1] if len(batch) % 2 == 1 else None
                mel, yy = val_preprocess(*batch[:2])
                vmetrics = eval_step(state, vmetrics, mel, yy, latlng=latlng)
                if collect_confusion:
                    y_pred_parts.append(
                        confusion_predict(state, mel).float().cpu().numpy())
                    y_true_parts.append(yy.float().cpu().numpy())
            for k, v in metrics_compute(vmetrics).items():
                logs[f"val_{k}"] = v
            if y_true_parts:
                base = _write_epoch_confusion(
                    run_dir / "epoch-confusion", epoch,
                    np.concatenate(y_true_parts),
                    np.concatenate(y_pred_parts),
                    confusion_labels, multi_label,
                )
                png = base.with_suffix(".png")
                if png.exists():
                    tb.add_image("epoch_confusion", png.read_bytes(), epoch)

        logs["lr"] = state.current_lr()
        logs["epoch_time"] = time.time() - t0
        for k, v in logs.items():
            history.setdefault(k, []).append(v)
        log.info("epoch %d/%d steps=%d %s", epoch + 1, epochs, n_steps,
                 {k: round(v, 4) for k, v in logs.items()})
        if scalar_log is not None:
            scalar_log.append(epoch, logs)
        if tb is not None:
            tb.add_scalars(logs, epoch)
        if hist_writer is not None:
            hist_writer(epoch, logs, state, tb)

        # failure detection: a non-finite train loss means this epoch's
        # updates are poison — roll back to the last good per-epoch
        # checkpoint instead of checkpointing/score-tracking the wreck.
        # Two consecutive poisoned epochs abort the run.
        if not np.isfinite(logs.get("loss", 0.0)):
            nan_epochs += 1
            chkpt = run_dir / f"chkpt{SUFFIX}" if run_dir is not None else None
            if nan_epochs >= 2 or chkpt is None or not chkpt.exists():
                log.error("non-finite loss at epoch %d (%d in a row): "
                          "stopping", epoch + 1, nan_epochs)
                break
            log.error("non-finite loss at epoch %d: restoring %s and "
                      "continuing", epoch + 1, chkpt)
            # the NaN gradients also poisoned the optimizer moments —
            # restoring the weights alone would re-diverge on the next step
            state = restore_into(state, chkpt).reset_optimizer()
            continue
        nan_epochs = 0

        if tracker is not None:
            tracker.update(epoch, logs, state)
        state = reducer.update(logs, state)
        if stopper.update(logs):
            log.info("early stopping at epoch %d", epoch + 1)
            break
        if n_steps == 0:
            log.warning("no training batches; stopping")
            break

    if tb is not None:
        tb.close()
    if run_dir is not None:
        (run_dir / "history.json").write_text(
            json.dumps(history, indent=2, default=float))
    return FitResult(state=state, history=history, epochs_run=epoch + 1)
