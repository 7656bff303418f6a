"""Per-class decision-threshold search + pre/species model combination (a
port of ``audio_training_tpu/eval/thresholds.py``; preeval.py capability
parity).

The JAX module takes the precision-recall curve from scikit-learn, which
the port does not depend on: :func:`precision_recall_curve` computes it in
numpy with the semantics of scikit-learn 1.9's (every distinct score a
threshold, ascending, none dropped, precision 1 and recall 0 appended).
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def precision_recall_curve(y_true, y_score):
    """``sklearn.metrics.precision_recall_curve(y_true, y_score)`` for 0/1
    labels: (precision, recall, thresholds), thresholds the distinct scores
    ascending, precision and recall one longer, ending in 1 and 0."""
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(-y_score, kind="stable")  # descending
    y_score = y_score[order]
    hits = (np.asarray(y_true).ravel()[order] == 1).astype(np.float64)
    # the last sample of each run of equal scores, and the last sample
    idx = np.r_[np.flatnonzero(np.diff(y_score)), hits.size - 1]
    tps = np.cumsum(hits)[idx]
    fps = 1 + idx - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            y_score[idx][::-1])


def best_thresholds(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    labels: list[str],
    clip_min: float = 0.5,
    clip_max: float = 0.9,
) -> dict[str, float]:
    """Best F-score threshold per class from the PR curve
    (preeval.best_threshold, preeval.py:396-471), clipped to [0.5, 0.9]
    (preeval.py:212-221)."""
    out: dict[str, float] = {}
    for i, label in enumerate(labels):
        yt = y_true[:, i]
        if yt.sum() == 0:
            out[label] = clip_max
            continue
        precision, recall, thresholds = precision_recall_curve(yt, y_pred[:, i])
        with np.errstate(divide="ignore", invalid="ignore"):
            f = np.nan_to_num(
                2 * precision * recall / (precision + recall)
            )
        ix = int(np.argmax(f[:-1])) if len(f) > 1 else 0
        thresh = float(thresholds[min(ix, len(thresholds) - 1)])
        out[label] = float(np.clip(thresh, clip_min, clip_max))
    return out


def combine_pre_model(
    species_pred: np.ndarray,
    species_labels: list[str],
    pre_pred: np.ndarray,
    pre_labels: list[str],
    pre_thresh: float = 0.7,
) -> np.ndarray:
    """Gate species predictions with a bird/human/noise "pre model"
    (preeval.main, preeval.py:39-140): when the pre model is confident the
    clip is noise or human, species probabilities are suppressed."""
    out = species_pred.copy()
    for gate in ("noise", "human"):
        if gate not in pre_labels:
            continue
        gi = pre_labels.index(gate)
        confident = pre_pred[:, gi] >= pre_thresh
        keep = [
            i for i, l in enumerate(species_labels) if l in ("noise", "human")
        ]
        mask = np.ones(len(species_labels), bool)
        mask[keep] = False
        out[confident] = np.where(mask, 0.0, out[confident])
    return out


# The reference's SHIPPED per-class threshold table for its production
# 67-label species model + 6-label pre (bird/human/noise gate) model
# (preeval.py:143-221), stored there in percent.  The labels are positional
# — preeval.py reads them from the paired stats .npy at runtime — so the
# table is model-specific data; it is shipped here verbatim so a migrating
# user keeps the production operating points.
_REFERENCE_SHIPPED_THRESHOLDS_PCT = (
    0.8, 90.4, 0.0, 0.0, 62.1, 0.0, 87.7, 1.1, 30.7, 0.0, 0.0, 0.0, 30.5,
    0.0, 93.6, 70.2, 2.0, 30.9, 77.7, 0.0, 8.6, 72.4, 3.0, 89.3, 55.0, 0.0,
    75.7, 1.3, 0.0, 14.5, 87.8, 19.6, 0.0, 37.5, 0.0, 0.0, 89.7, 35.3, 0.0,
    3.8, 24.2, 0.4, 0.0, 0.2, 0.0, 0.1, 22.5, 83.0, 2.2, 32.7, 96.8, 0.0,
    49.6, 0.0, 0.0, 99.9, 29.6, 0.0, 18.8, 0.0, 0.0, 0.0, 30.8, 8.6, 0.0,
    0.0, 0.0,
)
_REFERENCE_SHIPPED_PRE_THRESHOLDS_PCT = (0.0, 61.3, 16.2, 92.2, 72.7, 0.0)


def reference_shipped_thresholds(
    clip_min: float = 0.5, clip_max: float = 0.9
) -> tuple[np.ndarray, np.ndarray]:
    """(species_thresholds, pre_model_thresholds) as the reference applies
    them: percent -> fraction, clipped to [0.5, 0.9]
    (preeval.py:209-221)."""
    species = np.asarray(_REFERENCE_SHIPPED_THRESHOLDS_PCT) / 100.0
    pre = np.asarray(_REFERENCE_SHIPPED_PRE_THRESHOLDS_PCT) / 100.0
    return (
        np.clip(species, clip_min, clip_max),
        np.clip(pre, clip_min, clip_max),
    )


def reference_shipped_thresholds_dict(
    labels: list[str],
    pre_labels: list[str] | None = None,
    clip_min: float = 0.5,
    clip_max: float = 0.9,
) -> tuple[dict[str, float], dict[str, float] | None]:
    """The shipped table keyed by label, ready for ``apply_thresholds``.

    The reference stores the table positionally (preeval.py:143-221 reads
    the label order from the paired stats .npy at runtime), so the caller
    supplies the production model's label list; lengths are checked against
    the 67-entry species table (and the 6-entry pre table when
    ``pre_labels`` is given)."""
    species, pre = reference_shipped_thresholds(clip_min, clip_max)
    if len(labels) != len(species):
        raise ValueError(
            f"the shipped species table has {len(species)} entries; got "
            f"{len(labels)} labels — it is positional data for the "
            "production 67-label model only"
        )
    species_d = {l: float(t) for l, t in zip(labels, species)}
    pre_d = None
    if pre_labels is not None:
        if len(pre_labels) != len(pre):
            raise ValueError(
                f"the shipped pre-model table has {len(pre)} entries; got "
                f"{len(pre_labels)} labels"
            )
        pre_d = {l: float(t) for l, t in zip(pre_labels, pre)}
    return species_d, pre_d


def apply_thresholds(
    y_pred: np.ndarray, labels: list[str], thresholds: dict[str, float],
    default: float = 0.7,
) -> np.ndarray:
    """Binary decisions using per-class thresholds."""
    t = np.array([thresholds.get(l, default) for l in labels], y_pred.dtype)
    return (y_pred >= t).astype(np.float32)
