"""Weak-label directory evaluation (a port of
``audio_training_tpu/eval/weak.py``; evaluate.py:23-299 capability
parity).

Directory layout: ``<dir>/<label>/<audio files>`` — the folder name is the
weak (recording-level) label.  Each file runs through track detection ->
windowing -> the Predictor on the card; per-track mean and count-vote
aggregations produce two confusion matrices plus raw dumps.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.eval.confusion import (
    confusion_matrix,
    save_confusion,
)
from audio_training_tpu_torch.eval.prep import (
    DEFAULT_EVAL_WORKERS,
    preprocessed_eval_stream,
)
from audio_training_tpu_torch.infer.predictor import Predictor, aggregate_tracks

log = logging.getLogger(__name__)


@dataclass
class WeakEvalResult:
    labels: list[str]
    mean_cm: np.ndarray
    votes_cm: np.ndarray
    per_file: list[dict] = field(default_factory=list)


def evaluate_weakly_labelled_dir(
    predictor: Predictor,
    dir_name: str | Path,
    out_prefix: str | Path | None = None,
    threshold: float = 0.7,
    workers: int = DEFAULT_EVAL_WORKERS,
) -> WeakEvalResult:
    """``workers`` files are decoded/detected/windowed concurrently in a
    process pool (the reference's 8-proc prep, evaluate.py:81); prediction
    and aggregation stay in the parent, on the card."""
    dir_name = Path(dir_name)
    labels = list(predictor.labels)
    if "None" not in labels:
        labels = labels + ["None"]
    none_i = labels.index("None")

    mean_true, mean_pred = [], []
    votes_true, votes_pred = [], []
    per_file = []

    audio_files: list[tuple[str, Path]] = []
    for sub_dir in sorted(dir_name.iterdir()):
        if sub_dir.is_file():
            continue
        for f in sorted(sub_dir.iterdir()):
            if f.is_file() and f.suffix.lower() in (".wav", ".mp3", ".m4a",
                                                    ".flac"):
                if sub_dir.name not in labels:
                    log.info("Skipping %s: label %s not in model", f,
                             sub_dir.name)
                    continue
                audio_files.append((sub_dir.name, f))

    stream = preprocessed_eval_stream(
        [((true_label, str(path)), path) for true_label, path in audio_files],
        predictor.cfg, workers=workers,
    )
    for count, (key, windows, track_index, num_tracks, err) in enumerate(
            stream):
        true_label, path = key
        if count % 100 == 0:
            log.info("Done %s / %s", count, len(audio_files))
        true_i = labels.index(true_label)
        if err is not None:
            log.error("preprocessing failed for %s: %s", path, err)
            continue
        try:
            probs = predictor.predict_windows(windows)
            results = aggregate_tracks(
                probs, track_index, num_tracks, predictor.labels,
                threshold=threshold, model_name=predictor.model_name,
                mode=predictor.infer_cfg.aggregation,
            )
        except Exception:
            log.error("prediction failed for %s", path, exc_info=True)
            continue
        real = [r for r in results if r is not None]
        if not real:
            mean_true.append(true_i)
            mean_pred.append(none_i)
            votes_true.append(true_i)
            votes_pred.append(none_i)
            per_file.append({"file": str(path), "true": true_label,
                             "tracks": 0})
            continue

        # file-level aggregation over tracks: any track predicting the label
        file_label_mean = none_i
        best_conf = 0
        vote_counts = np.zeros(len(labels))
        for r in real:
            for l, c in zip(r.labels, r.confidences):
                li = labels.index(l)
                vote_counts[li] += 1
                if c > best_conf:
                    best_conf = c
                    file_label_mean = li
        file_label_votes = (
            int(vote_counts.argmax()) if vote_counts.any() else none_i
        )
        mean_true.append(true_i)
        mean_pred.append(file_label_mean)
        votes_true.append(true_i)
        votes_pred.append(file_label_votes)
        per_file.append({
            "file": str(path),
            "true": true_label,
            "mean_pred": labels[file_label_mean],
            "votes_pred": labels[file_label_votes],
            "tracks": len(real),
        })

    mean_cm = confusion_matrix(mean_true, mean_pred, len(labels))
    votes_cm = confusion_matrix(votes_true, votes_pred, len(labels))
    if out_prefix is not None:
        out_prefix = Path(out_prefix)
        save_confusion(mean_cm, labels, out_prefix.parent /
                       f"{out_prefix.name}-mean")
        save_confusion(votes_cm, labels, out_prefix.parent /
                       f"{out_prefix.name}-votes")
    return WeakEvalResult(labels=labels, mean_cm=mean_cm, votes_cm=votes_cm,
                          per_file=per_file)
