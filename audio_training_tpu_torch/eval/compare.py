"""A/B comparison of two saved confusion matrices (a copy of
``audio_training_tpu/eval/compare.py``; confusioncompare.py:22-241):
per-label accuracy deltas, incorrect-score metric, winner call."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

PRE_LABELS = ["bird", "human", "noise"]
SKIP_LABELS = ["human", "morepo2"]  # confusioncompare.py:111-112


@dataclass
class CompareResult:
    per_label: dict = field(default_factory=dict)
    total_diff: int = 0
    total_samples: int = 0
    first_incorrect: int = 0
    second_incorrect: int = 0
    first_correct: int = 0
    second_correct: int = 0
    winner: str = "tie"

    @property
    def accuracy_diff_percent(self) -> float:
        if self.total_samples == 0:
            return 0.0
        return round(100 * self.total_diff / self.total_samples, 1)

    @property
    def incorrect_score_percent(self) -> float:
        if self.total_samples == 0:
            return 0.0
        return round(
            100 * (self.first_incorrect - self.second_incorrect)
            / self.total_samples, 1,
        )


def _zero_masked_row(cm, i, labels, label):
    """A row with diagonal, None column, bird and (for noise) insect zeroed
    so argmax finds the worst *real* confusion."""
    row = cm[i].copy().astype(np.int64)
    if "bird" in labels:
        row[labels.index("bird")] = 0
    if label == "noise" and "insect" in labels:
        row[labels.index("insect")] = 0
    row[i] = 0
    row[-1] = 0
    return row


def compare_confusions(
    first_cm: np.ndarray,
    first_labels: list[str],
    second_cm: np.ndarray,
    second_labels: list[str],
) -> CompareResult:
    first_labels = list(first_labels)
    second_labels = list(second_labels)
    # cms carry an extra None column beyond the labels
    if len(first_cm[0]) != len(first_labels) + 1:
        first_labels.extend(PRE_LABELS)
    if len(second_cm[0]) != len(second_labels) + 1:
        second_labels.extend(PRE_LABELS)

    res = CompareResult()
    for i, label in enumerate(first_labels):
        if label in SKIP_LABELS:
            continue
        if label not in second_labels:
            log.info("Label %s only in first", label)
            continue
        first_count = int(first_cm[i][i])
        first_none = int(first_cm[i][-1])
        first_total = int(np.sum(first_cm[i]))
        res.total_samples += first_total
        res.first_correct += first_count

        first_bird_c = (
            int(first_cm[i][first_labels.index("bird")])
            if "bird" in first_labels else 0
        )
        most_wrong = int(np.argmax(_zero_masked_row(first_cm, i,
                                                    first_labels, label)))

        second_i = second_labels.index(label)
        second_count = int(second_cm[second_i][second_i])
        second_none = int(second_cm[second_i][-1])
        second_total = int(np.sum(second_cm[second_i]))
        res.second_correct += second_count
        second_most_wrong = int(
            np.argmax(_zero_masked_row(second_cm, second_i, second_labels,
                                       label))
        )
        if second_total != first_total:
            raise ValueError(
                f"{label}: first total {first_total} != second {second_total}"
            )
        bird_c = (
            int(second_cm[second_i][second_labels.index("bird")])
            if "bird" in second_labels else 0
        )
        if label in PRE_LABELS:
            first_bird_c = 0
            bird_c = 0
        res.first_incorrect += first_total - first_count - first_none - first_bird_c
        res.second_incorrect += second_total - second_count - second_none - bird_c
        res.total_diff += first_count - second_count

        res.per_label[label] = {
            "first_acc": round(100 * first_count / first_total) if first_total else 0,
            "second_acc": round(100 * second_count / second_total) if second_total else 0,
            "first_none": round(100 * first_none / first_total) if first_total else 0,
            "second_none": round(100 * second_none / second_total) if second_total else 0,
            "sample_diff": first_count - second_count,
            "first_most_wrong": first_labels[most_wrong],
            "second_most_wrong": second_labels[second_most_wrong],
            "total": first_total,
        }

    res.winner = "first" if res.total_diff > 0 else (
        "second" if res.total_diff < 0 else "tie"
    )
    return res
