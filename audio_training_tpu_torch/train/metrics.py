"""Metrics (port of ``audio_training_tpu/train/metrics.py:19-208``) —
parity with the reference compile set (audiomodel.py:858-871): binary /
categorical accuracy, AUC, precision, recall, focal-BCE, Huber, plus the
precAtK top-k metric (audiomodel.py:2653-2717).

Accumulators as in the JAX package: ``init() -> state``, ``update(state,
...) -> state``, ``compute(state) -> value``; states are tensors on the
batch's device.  Under an entered data-parallel mesh each rank accumulates
its rows, and ``compute`` sums the states over the ranks first, so every
rank reports the global batch's metrics, as JAX's sharded sums are.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from audio_training_tpu_torch.parallel.collectives import sum_over_ranks
from audio_training_tpu_torch.parallel.mesh import active_mesh
from audio_training_tpu_torch.train.losses import focal_bce_from_logits, huber

NUM_THRESHOLDS = 200


def binary_accuracy(probs: torch.Tensor, labels: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    """tf.metrics.binary_accuracy semantics: elementwise match rate."""
    return ((probs > threshold).float() == labels).float().mean()


def categorical_accuracy(probs: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    return (probs.argmax(-1) == labels.argmax(-1)).float().mean()


# ---------------------------------------------------------------------------
# Streaming AUC / precision / recall over fixed thresholds (the Keras way)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConfusionState:
    tp: torch.Tensor  # (T,)
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor


def confusion_init(num_thresholds: int = NUM_THRESHOLDS,
                   device: str | torch.device = "cpu") -> ConfusionState:
    return ConfusionState(*(torch.zeros(num_thresholds, device=device)
                            for _ in range(4)))


def _thresholds(n: int, device) -> torch.Tensor:
    # Keras AUC threshold spacing: (n-2) evenly spaced in (0,1) plus
    # -eps / 1+eps
    t = torch.linspace(0.0, 1.0, n, device=device)
    t[0], t[-1] = -1e-7, 1.0 + 1e-7
    return t


def confusion_update(state: ConfusionState, probs: torch.Tensor,
                     labels: torch.Tensor) -> ConfusionState:
    t = _thresholds(state.tp.shape[0], probs.device)
    p = probs.reshape(-1)[None, :] > t[:, None]  # (T, N)
    y = labels.reshape(-1)[None, :] > 0.5
    count = lambda m: m.sum(-1).float()
    return ConfusionState(state.tp + count(p & y), state.fp + count(p & ~y),
                          state.tn + count(~p & ~y), state.fn + count(~p & y))


def auc_compute(state: ConfusionState) -> torch.Tensor:
    """ROC AUC by trapezoidal interpolation over the threshold grid
    (tf.keras.metrics.AUC equivalent)."""
    tpr = state.tp / (state.tp + state.fn).clamp_min(1e-7)
    fpr = state.fp / (state.fp + state.tn).clamp_min(1e-7)
    # thresholds ascend -> fpr/tpr descend; integrate over fpr
    return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


def precision_compute(state: ConfusionState) -> torch.Tensor:
    """Precision at threshold 0.5 (Keras default)."""
    i = state.tp.shape[0] // 2
    return state.tp[i] / (state.tp[i] + state.fp[i]).clamp_min(1e-7)


def recall_compute(state: ConfusionState) -> torch.Tensor:
    i = state.tp.shape[0] // 2
    return state.tp[i] / (state.tp[i] + state.fn[i]).clamp_min(1e-7)


# ---------------------------------------------------------------------------
# precAtK (audiomodel.py:2653-2717)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecAtKState:
    hits: torch.Tensor  # weighted intersection count
    total: torch.Tensor  # number of true positives considered


def prec_at_k_init(device: str | torch.device = "cpu") -> PrecAtKState:
    return PrecAtKState(torch.zeros((), device=device),
                        torch.zeros((), device=device))


def prec_at_k_update(
    state: PrecAtKState,
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    k: int = 3,
    bird_index: int | None = None,
    weighting: torch.Tensor | None = None,
) -> PrecAtKState:
    """Top-k overlap between predicted and true label sets, optionally
    ignoring the generic ``bird`` output and weighting per-label hits
    (audiomodel.precAtK.update_state): zero-valued entries count toward
    neither set; the result is sum(|topk(pred) & topk(true)|) /
    sum(|topk(true)|)."""
    if bird_index is not None:
        mask = torch.ones(y_true.shape[-1], device=y_true.device)
        mask[bird_index] = 0.0
        y_pred, y_true = y_pred * mask, y_true * mask
    pred_v, pred_i = torch.topk(y_pred, k)
    true_v, true_i = torch.topk(y_true, k)
    pred_hot = torch.zeros(y_pred.shape, dtype=torch.bool,
                           device=y_pred.device).scatter(1, pred_i, pred_v > 0)
    true_hot = torch.zeros(y_true.shape, dtype=torch.bool,
                           device=y_true.device).scatter(1, true_i, true_v > 0)
    inter = (pred_hot & true_hot).float()
    hits = (inter * weighting).sum() if weighting is not None else inter.sum()
    return PrecAtKState(state.hits + hits,
                        state.total + true_hot.sum().float())


def prec_at_k_compute(state: PrecAtKState) -> torch.Tensor:
    hits, total = _global(state.hits, state.total)
    return hits / total.clamp_min(1.0)


def _global(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors summed over the ranks of the entered data-parallel
    mesh; as they are without one."""
    mesh = active_mesh()
    return list(tensors) if mesh is None else sum_over_ranks(mesh,
                                                             list(tensors))


# ---------------------------------------------------------------------------
# Bundled metric set used by the train loop
# ---------------------------------------------------------------------------


def metrics_init(device: str | torch.device = "cpu") -> dict:
    zero = lambda: torch.zeros((), device=device)
    return {"confusion": confusion_init(device=device), "loss_sum": zero(),
            "acc_sum": zero(), "focal_sum": zero(), "huber_sum": zero(),
            "count": zero()}


def metrics_update(state: dict, loss: torch.Tensor, probs: torch.Tensor,
                   labels: torch.Tensor, multi_label: bool = True) -> dict:
    clipped = probs.clamp(1e-7, 1 - 1e-7)
    logits = torch.log(clipped) - torch.log1p(-clipped)
    acc = (binary_accuracy(probs, labels) if multi_label
           else categorical_accuracy(probs, labels))
    # per-batch means weighted by batch size, so a partial tail batch
    # contributes proportionally to the epoch means
    w = float(probs.shape[0])
    return {
        "confusion": confusion_update(state["confusion"], probs, labels),
        "loss_sum": state["loss_sum"] + loss * w,
        "acc_sum": state["acc_sum"] + acc * w,
        "focal_sum": state["focal_sum"]
        + focal_bce_from_logits(logits, labels) * w,
        "huber_sum": state["huber_sum"] + huber(probs, labels) * w,
        "count": state["count"] + w,
    }


def metrics_compute(state: dict) -> dict[str, float]:
    c = state["confusion"]
    keys = ("loss_sum", "acc_sum", "focal_sum", "huber_sum", "count")
    summed = _global(*(state[k] for k in keys), c.tp, c.fp, c.tn, c.fn)
    state = dict(zip(keys, summed))
    conf = ConfusionState(*summed[len(keys):])
    n = max(float(state["count"]), 1.0)
    return {
        "loss": float(state["loss_sum"]) / n,
        "accuracy": float(state["acc_sum"]) / n,
        "auc": float(auc_compute(conf)),
        "precision": float(precision_compute(conf)),
        "recall": float(recall_compute(conf)),
        "focal": float(state["focal_sum"]) / n,
        "huber": float(state["huber_sum"]) / n,
    }
