"""Loss zoo (port of ``audio_training_tpu/train/losses.py:16-139``) —
parity with the reference's losses (audiomodel.py:1194-1240, 2437-2650) but
computed on *logits* for numerical stability, as the JAX package does.

Under an entered data-parallel mesh the soft-F1 losses sum their per-label
counts over the ranks (with a gradient), so that, like JAX's, they are the
global batch's; every other loss is a mean over rows, whose per-rank values
DistributedDataParallel's gradient mean already makes global."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_training_tpu_torch.parallel.collectives import all_reduce_sum
from audio_training_tpu_torch.parallel.mesh import active_mesh

EPS = 1e-7  # keras backend epsilon


def bce_from_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binary cross-entropy, mean over labels then batch
    (tf.keras.losses.BinaryCrossentropy, audiomodel.py:1206-1223)."""
    if label_smoothing:
        labels = labels * (1.0 - label_smoothing) + 0.5 * label_smoothing
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    if class_weights is not None:
        per = per * torch.as_tensor(class_weights, dtype=per.dtype,
                                    device=per.device)
    return per.mean(dim=-1).mean()


def cce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    label_smoothing: float = 0.0) -> torch.Tensor:
    """Categorical cross-entropy (softmax) for single-label mode."""
    if label_smoothing:
        n = labels.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / n
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def weighted_cross_entropy_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, possible_labels: torch.Tensor
) -> torch.Tensor:
    """The "bird_cross_entropy" (audiomodel.WeightedCrossEntropy,
    audiomodel.py:2606-2650): negative-class terms are masked by
    ``possible_labels`` (1 where a negative prediction is punished), so a
    specific-species guess on a generic-bird clip isn't penalized."""
    p = torch.sigmoid(logits).clamp(EPS, 1.0 - EPS)
    term_0 = (1.0 - labels) * torch.log1p(-p + EPS) * possible_labels
    term_1 = labels * torch.log(p + EPS)
    return -(term_0 + term_1).mean(dim=-1).mean()


def _soft_counts(logits, labels):
    y = labels.float()
    y_hat = torch.sigmoid(logits)
    tp = (y_hat * y).sum(dim=0)
    fp = (y_hat * (1.0 - y)).sum(dim=0)
    fn = ((1.0 - y_hat) * y).sum(dim=0)
    tn = ((1.0 - y_hat) * (1.0 - y)).sum(dim=0)
    mesh = active_mesh()
    if mesh is not None:  # the global batch's counts, in one all-reduce
        tp, fp, fn, tn = all_reduce_sum(mesh, torch.stack([tp, fp, fn, tn]))
    return tp, fp, fn, tn


def macro_soft_f1(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """1 - mean soft-F1 across labels (audiomodel.macro_soft_f1,
    audiomodel.py:2437-2460)."""
    tp, fp, fn, _ = _soft_counts(logits, labels)
    soft_f1 = 2.0 * tp / (2.0 * tp + fn + fp + 1e-16)
    return (1.0 - soft_f1).mean()


def macro_double_soft_f1(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Both-class soft-F1 cost: mean over labels of
    0.5 * ((1 - softF1_pos) + (1 - softF1_neg))
    (audiomodel.macro_double_soft_f1, audiomodel.py:2550-2580)."""
    tp, fp, fn, tn = _soft_counts(logits, labels)
    f1_pos = 2.0 * tp / (2.0 * tp + fn + fp + 1e-16)
    f1_neg = 2.0 * tn / (2.0 * tn + fn + fp + 1e-16)
    return (0.5 * ((1.0 - f1_pos) + (1.0 - f1_neg))).mean()


def macro_f1(probs: torch.Tensor, labels: torch.Tensor,
             thresh: float = 0.5) -> torch.Tensor:
    """Hard macro F1 at a threshold (audiomodel.macro_f1,
    audiomodel.py:2528-2548) — an evaluation metric, not a loss."""
    y = labels.float()
    y_pred = (probs > thresh).float()
    tp = (y_pred * y).sum(dim=0)
    fp = (y_pred * (1.0 - y)).sum(dim=0)
    fn = ((1.0 - y_pred) * y).sum(dim=0)
    return (2.0 * tp / (2.0 * tp + fn + fp + 1e-16)).mean()


def focal_bce_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
    alpha: float | None = None,
) -> torch.Tensor:
    """Binary focal cross-entropy (a tracked metric in the reference
    compile, audiomodel.py:866)."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    mod = (1.0 - p_t) ** gamma
    if alpha is not None:
        mod = mod * (labels * alpha + (1.0 - labels) * (1.0 - alpha))
    return (mod * ce).mean(dim=-1).mean()


def huber(probs: torch.Tensor, labels: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """Huber distance between probabilities and targets (tracked as a
    metric, audiomodel.py:869)."""
    abs_err = (probs - labels).abs()
    quad = abs_err.clamp(max=delta)
    return (0.5 * quad**2 + delta * (abs_err - quad)).mean()


LOSSES = {
    "bce": bce_from_logits,
    "cce": cce_from_logits,
    "weighted_bce": weighted_cross_entropy_from_logits,
    "soft_f1": macro_soft_f1,
    "double_soft_f1": macro_double_soft_f1,
    "focal": focal_bce_from_logits,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name}; have {sorted(LOSSES)}")
    return LOSSES[name]
