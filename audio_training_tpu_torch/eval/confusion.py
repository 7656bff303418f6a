"""Confusion tooling (audiomodel.confusion / multi_confusion_single,
audiomodel.py:1317-1569): single-label argmax-thresholded confusion with a
"None" column, the multi-label flattened confusion plus the "None" matrix of
near-miss predictions, raw prediction dumps, and the rendered matrix PNG.

A copy of ``audio_training_tpu/eval/confusion.py:20-227``.  Without
matplotlib, ``save_confusion`` writes the ``.npy`` and skips the PNG with a
warning.
"""

from __future__ import annotations

import itertools
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.taxonomy.ebird import get_ebird_ids_to_labels

log = logging.getLogger(__name__)


def display_labels(ebird_labels: list[str]) -> list[str]:
    """eBird ids -> first common name (audiomodel.py:1328-1333)."""
    id_map = get_ebird_ids_to_labels()
    return [id_map.get(e, [e])[0] for e in ebird_labels]


def confusion_matrix(y_true, y_pred, num_labels: int) -> np.ndarray:
    cm = np.zeros((num_labels, num_labels), np.int64)
    for t, p in zip(y_true, y_pred):
        cm[int(t), int(p)] += 1
    return cm


def single_label_confusion(
    y_true_onehot: np.ndarray,
    y_pred: np.ndarray,
    labels: list[str],
    threshold: float = 0.7,
) -> tuple[np.ndarray, list[str]]:
    """Argmax prediction with a confidence threshold; below-threshold rows
    land in the appended "None" class (audiomodel.py:1430-1441)."""
    labels = list(labels)
    if "None" not in labels:
        labels.append("None")
    y_true = np.argmax(y_true_onehot, axis=1)
    preds = []
    for p in y_pred:
        max_i = int(np.argmax(p))
        preds.append(max_i if p[max_i] > threshold else len(labels) - 1)
    return confusion_matrix(y_true, preds, len(labels)), labels


def multi_label_confusion(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    labels: list[str],
    prob_thresh: float = 0.7,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Flattened multi-label confusion (audiomodel.multi_confusion_single,
    audiomodel.py:1448-1569).

    Per (sample, label): correct positives land on the diagonal; false
    positives are charged against every true label; missed positives go to
    the "nothing" column, and confident near-misses (best prob >= 0.3 with
    nothing over threshold) populate the secondary "none" matrix.
    Returns (cm, none_cm, labels+["nothing"]).
    """
    labels = list(labels)
    if "nothing" not in labels:
        labels.append("nothing")
    bird_index = labels.index("bird") if "bird" in labels else None
    flat_y, flat_p, none_y, none_p = [], [], [], []
    for y, p in zip(y_true, y_pred):
        arg_sorted = np.argsort(p)
        best_label = arg_sorted[-1]
        if (
            bird_index is not None
            and best_label == bird_index
            and p[arg_sorted[-2]] != 0
        ):
            best_label = arg_sorted[-2]
        best_prob = p[best_label]
        best_labels = np.argwhere(p > prob_thresh).ravel()
        true_labels = np.argwhere(y == 1).ravel()
        for index, (y_l, p_l) in enumerate(zip(y, p)):
            predicted = p_l >= prob_thresh
            if y_l == 0 and predicted:
                for true_label in true_labels:
                    flat_y.append(true_label)
                    flat_p.append(index)
            elif y_l == 1 and predicted:
                flat_y.append(index)
                flat_p.append(index)
            elif y_l == 1 and not predicted:
                flat_y.append(index)
                flat_p.append(len(labels) - 1)
                if best_prob >= 0.3 and len(best_labels) == 0:
                    if best_label not in true_labels:
                        none_y.append(index)
                        none_p.append(best_label)
    cm = confusion_matrix(flat_y, flat_p, len(labels))
    none_cm = confusion_matrix(none_y, none_p, len(labels))
    return cm, none_cm, labels


def save_confusion(
    cm: np.ndarray, labels: list[str], filename: str | Path,
    render: bool = True,
) -> None:
    """npy + PNG outputs (audiomodel.py:1438-1441)."""
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    np.save(str(filename.with_suffix(".npy")), cm)
    if render:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            log.warning("matplotlib is not installed: %s has no PNG",
                        filename.with_suffix(".npy"))
            return
        try:
            fig = plot_confusion_matrix(cm, labels)
            fig.savefig(str(filename.with_suffix(".png")), format="png")
            import matplotlib.pyplot as plt

            plt.close(fig)
        except Exception:
            log.warning("could not render confusion PNG", exc_info=True)


def save_raw_predictions(
    filename: str | Path,
    labels: list[str],
    y_pred: np.ndarray,
    y_true: np.ndarray,
    tracks=None,
    recs=None,
    starts=None,
) -> Path:
    """Raw .npy dump for offline analysis/preeval (audiomodel.py:1393-1410)."""
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    npy_file = filename.parent / f"{filename.stem}-raw.npy"
    with npy_file.open("wb") as f:
        np.save(f, np.array(labels))
        np.save(f, y_pred)
        np.save(f, y_true)
        np.save(f, np.array(tracks if tracks is not None else []))
        np.save(f, np.array(recs if recs is not None else []))
        np.save(f, np.array(starts if starts is not None else []))
    return npy_file


def load_raw_predictions(npy_file: str | Path) -> dict:
    with Path(npy_file).open("rb") as f:
        labels = np.load(f)
        y_pred = np.load(f)
        y_true = np.load(f)
        tracks = np.load(f, allow_pickle=True)
        recs = np.load(f, allow_pickle=True)
        starts = np.load(f, allow_pickle=True)
    return {
        "labels": list(labels), "y_pred": y_pred, "y_true": y_true,
        "tracks": tracks, "recs": recs, "starts": starts,
    }


def mean_model_confusion(
    dumps: list[dict],
    weights: list[float] | None = None,
    threshold: float = 0.7,
) -> tuple[np.ndarray, list[str], np.ndarray]:
    """Weighted-average ensemble confusion over per-model raw dumps of the
    SAME test stream (audiomodel ``--model_2``: ``confusion(...,
    other_models)`` averages predictions with weights [0.6, 0.4] before the
    argmax/None thresholding, audiomodel.py:1363-1386,1432-1441).

    Each dump is a ``load_raw_predictions`` dict; y_true and labels must
    match across dumps (same deterministic test stream).  Returns
    (cm, labels_with_None, y_pred_mean)."""
    if len(dumps) < 2:
        raise ValueError("need at least two raw dumps to ensemble")
    if weights is None:
        # the reference hard-codes [0.6, 0.4] for one extra model; extend
        # uniformly beyond two
        weights = [0.6, 0.4] if len(dumps) == 2 else [1.0] * len(dumps)
    if len(weights) != len(dumps):
        raise ValueError(f"{len(weights)} weights for {len(dumps)} dumps")
    first = dumps[0]
    for d in dumps[1:]:
        if list(d["labels"]) != list(first["labels"]):
            raise ValueError("raw dumps have different label sets")
        if d["y_true"].shape != first["y_true"].shape or not np.array_equal(
                d["y_true"], first["y_true"]):
            raise ValueError(
                "raw dumps disagree on y_true — not the same test stream"
            )
    y_pred = np.average(
        np.stack([d["y_pred"] for d in dumps]), axis=0, weights=weights
    )
    cm, out_labels = single_label_confusion(
        first["y_true"], y_pred, list(first["labels"]), threshold=threshold
    )
    return cm, out_labels, y_pred


def plot_confusion_matrix(cm: np.ndarray, class_names: list[str]):
    """Rendered matrix with row-normalized percentages
    (evaluate.plot_confusion_matrix, evaluate.py:303-338)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figure = plt.figure(figsize=(24, 24))
    plt.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    ticks = np.arange(len(class_names))
    plt.xticks(ticks, class_names, rotation=45)
    plt.yticks(ticks, class_names)

    counts = cm.copy()
    threshold = counts.max() / 2.0 if counts.size else 0
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = cm.astype(float) / cm.sum(axis=1)[:, np.newaxis]
    norm = np.uint8(np.round(np.nan_to_num(norm) * 100))
    for i, j in itertools.product(range(cm.shape[0]), range(cm.shape[1])):
        color = "white" if counts[i, j] > threshold else "black"
        plt.text(j, i, norm[i, j], horizontalalignment="center", color=color)
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    return figure
