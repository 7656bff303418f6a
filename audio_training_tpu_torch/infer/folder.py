"""Folder / test-split prediction checks (a port of
``audio_training_tpu/infer/folder.py``; predict.predict_on_folder,
predict.py:477-596; predict.predict_on_test, predict.py:599-720).

``predict_on_folder`` scores recordings whose sidecar carries a
``best_track`` annotation: the annotated span is windowed, classified by
the Predictor on the card, and counted correct when the annotated label
clears the threshold.  ``predict_on_test`` re-derives the held-out test
split from a pinned split file, classifies every stored sample (one
``predict_windows`` call a recording), and writes an argmax-vs-truth
confusion.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.corpus.audioio import load_recording
from audio_training_tpu_torch.eval.confusion import (
    confusion_matrix,
    save_confusion,
)
from audio_training_tpu_torch.eval.strong import find_audio_file

log = logging.getLogger(__name__)


@dataclass
class FolderPredictResult:
    total_files: int = 0
    total_correct: int = 0
    per_file: list[dict] = field(default_factory=list)

    @property
    def accuracy(self) -> float:
        return self.total_correct / self.total_files if self.total_files else 0.0


def predict_on_folder(
    predictor,
    base_dir: str | Path,
    threshold: float | None = None,
    label_overrides: dict[str, str] | None = None,
    workers: int = 1,
) -> FolderPredictResult:
    """Score every ``best_track``-annotated recording under ``base_dir``
    (predict.py:511-596).  ``label_overrides`` reproduces the reference's
    morepo2 -> morepork rewrite (predict.py:570-571) generically.
    ``workers > 1`` decodes/windows files in a process pool while the
    parent predicts on the card (the eval-prep fan-out of evaluate.py:81)."""
    from audio_training_tpu_torch.eval.prep import preprocessed_span_stream

    base_dir = Path(base_dir)
    cfg = predictor.cfg
    threshold = (threshold if threshold is not None
                 else predictor.infer_cfg.threshold)
    labels = list(predictor.labels)
    label_overrides = label_overrides or {}
    result = FolderPredictResult()

    items = []
    for meta_file in sorted(base_dir.glob("**/*.txt")):
        audio_f = find_audio_file(meta_file)
        if audio_f is None:
            log.info("No recording for %s", meta_file)
            continue
        try:
            meta = json.loads(meta_file.read_text())
        except Exception:
            log.info("Could not load metadata %s", meta_file)
            continue
        best_track = meta.get("best_track")
        if not best_track:
            continue
        label = best_track["tags"][0]["what"]
        label = label_overrides.get(label, label)
        if label not in labels:
            log.info("Skipping %s: label %s not in model", meta_file, label)
            continue
        items.append(((str(meta_file), label), audio_f,
                      best_track["start"], best_track["end"]))

    for (meta_name, label), windows, err in preprocessed_span_stream(
            items, cfg, workers=workers):
        if err is not None:
            log.error("preprocessing failed for %s: %s", meta_name, err)
            continue
        if windows.shape[0] == 0:
            continue
        probs = predictor.predict_windows(windows).mean(axis=0)
        over = [labels[i] for i, p in enumerate(probs) if p >= threshold]
        label_conf = float(probs[labels.index(label)])
        correct = label in over
        result.total_files += 1
        result.total_correct += int(correct)
        result.per_file.append({
            "file": meta_name, "label": label, "correct": correct,
            "label_confidence": round(label_conf * 100),
            "predicted": over,
        })
        if not correct:
            log.info("%s %s has %s%% — predictions %s", meta_name, label,
                     round(label_conf * 100), over)
    log.info("Correct %s out of %s (%s%%)", result.total_correct,
             result.total_files, round(100 * result.accuracy))
    return result


def predict_on_test(
    predictor,
    split_file: str | Path,
    base_dir: str | Path,
    confusion_file: str | Path | None = None,
    remapped_labels: dict[str, int] | None = None,
    extra_label_map: dict[str, int] | None = None,
    sampling_config=None,
) -> tuple[np.ndarray, list[str]]:
    """Classify every stored sample of the pinned test split and build a
    single-label (argmax) confusion (predict.py:599-720).

    ``sampling_config`` defaults to the most permissive settings (no RMS
    filtering/tightening) so recordings without stored RMS metadata still
    yield samples; pass the build-time config to reproduce the exact split.
    """
    from audio_training_tpu_torch.config import SamplingConfig
    from audio_training_tpu_torch.corpus.dataset import AudioDataset
    from audio_training_tpu_torch.corpus.split import split_by_file

    cfg = predictor.cfg
    labels = list(predictor.labels)
    remapped_labels = remapped_labels or {}
    extra_label_map = extra_label_map or {}

    if sampling_config is None:
        sampling_config = SamplingConfig(tighten_tracks=False,
                                         filter_rms=False)
    dataset = AudioDataset("all", sampling_config)
    dataset.load_meta(base_dir)
    split_meta = json.loads(Path(split_file).read_text())
    _, _, test = split_by_file(dataset, split_meta)

    y_true: list[int] = []
    predicted: list[int] = []
    for rec in test.recs.values():
        if not any(l in labels for l in rec.human_tags):
            continue
        try:
            frames, sr = load_recording(rec.filename, target_sr=cfg.sr)
        except Exception:
            log.error("could not load %s", rec.filename, exc_info=True)
            continue
        file_y: list[int] = []
        windows: list[np.ndarray] = []
        n = cfg.samples_per_clip
        for sample in rec.samples:
            label = sample.tags[0] if sample.tags else None
            if label is None:
                continue
            if label in remapped_labels:
                label_i = int(remapped_labels[label])
                if label_i == -1:
                    label_i = int(extra_label_map.get(label, -1))
                    if label_i == -1:
                        log.info("Ignoring %s", label)
                        continue
            elif label in labels:
                label_i = labels.index(label)
            else:
                log.info("%s not in remapped %s", rec.filename, label)
                continue
            s = int(sample.start * sr)
            data = np.asarray(frames[s : s + n], np.float32)
            if data.size < n:
                data = np.pad(data, (0, n - data.size))
            file_y.append(label_i)
            windows.append(data)
        if not windows:
            continue
        probs = predictor.predict_windows(np.stack(windows))
        predicted.extend(int(i) for i in probs.argmax(axis=1))
        y_true.extend(file_y)

    cm = confusion_matrix(y_true, predicted, len(labels))
    if confusion_file is not None:
        save_confusion(cm, labels, Path(confusion_file))
    return cm, labels
