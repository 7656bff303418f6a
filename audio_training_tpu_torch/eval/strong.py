"""Strong-label directory evaluation (a port of
``audio_training_tpu/eval/strong.py``; reference: audiomodel.evaluate_dir,
audiomodel.py:1784-1976).

Directory layout: ``<dir>/**/<rec>.txt`` sidecars next to audio files — each
track inside the sidecar carries its own (strong) tag.  Host workers decode
audio and cut raw windows; the Predictor then featurizes and classifies
every window of a file on the card (the reference instead computes librosa
mels per window on the CPU pool).  Per-track mean / max / count-vote
aggregations at threshold 0.7 produce three confusion matrices plus raw
dumps.
"""

from __future__ import annotations

import json
import logging
import pickle
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.corpus.audioio import load_recording
from audio_training_tpu_torch.corpus.dataset import Recording
from audio_training_tpu_torch.detect import get_end
from audio_training_tpu_torch.eval.confusion import (
    confusion_matrix,
    save_confusion,
)
from audio_training_tpu_torch.infer.windows import extract_track_windows
from audio_training_tpu_torch.taxonomy.ontology import Ontology, load_ontology

log = logging.getLogger(__name__)

AUDIO_SUFFIXES = (".m4a", ".wav", ".mp3", ".flac")  # evaluate.py:262-268


def build_eval_label_space(
    model_labels: list[str],
    remapped_labels: dict[str, int] | None,
    ontology: Ontology | None = None,
) -> tuple[list[str], list[str], dict[str, int]]:
    """Evaluation label space (audiomodel.py:1790-1828): model labels plus
    bird/human/noise fallbacks and a trailing ``None`` class; every known
    noise/human/bird tag is admitted and remapped onto those outputs."""
    ontology = ontology or load_ontology()
    labels = list(model_labels)
    include = set(labels)
    for pre_l in ("bird", "human", "noise"):
        if pre_l not in labels:
            labels.append(pre_l)
    labels.append("None")

    remap = {
        k: int(v) for k, v in (remapped_labels or {}).items() if int(v) >= 0
    }
    include.update(remap)
    include.update(("noise", "human"))
    for l in ontology.noise_labels:
        include.add(l)
        remap[l] = labels.index("noise")
    for l in ontology.human_labels:
        include.add(l)
        remap[l] = labels.index("human")
    remap["human"] = labels.index("human")
    for l in ontology.all_birds:
        if l in labels:
            continue
        include.add(l)
        remap[l] = labels.index("bird")
    remap["bird"] = labels.index("bird")
    return labels, sorted(include), remap


def find_audio_file(meta_file: Path) -> Path | None:
    for suffix in AUDIO_SUFFIXES:
        f = meta_file.with_suffix(suffix)
        if f.exists():
            return f
    return None


def preprocess_strong_file(args):
    """Pool worker: sidecar -> (meta_file, track tags/ids, raw windows,
    per-window track index).  Mirrors evaluate.preprocess_audio
    (evaluate.py:260-299) but returns raw waveform windows — featurization
    happens on the card in the Predictor."""
    (meta_file, include_labels, sr, segment_length, stride, fmin, fmax) = args
    meta_file = Path(meta_file)
    try:
        audio_f = find_audio_file(meta_file)
        if audio_f is None:
            log.info("Could not find audio file for %s", meta_file)
            return None
        try:
            metadata = json.loads(meta_file.read_text())
        except Exception:
            log.info("Could not load metadata for %s", meta_file)
            return None
        rec = Recording(metadata, audio_f, None, load_samples=False)
        tracks = [t for t in rec.tracks if t.tag in include_labels]
        if not tracks:
            return None
        frames, file_sr = load_recording(audio_f, target_sr=sr)
        end = get_end(frames, file_sr)
        frames = frames[: int(file_sr * end)]
        batch = extract_track_windows(
            frames, file_sr, tracks,
            segment_length=segment_length, stride=stride,
            fmin=fmin, fmax=fmax,
        )
        if batch.windows.shape[0] == 0:
            return None
        tags = [t.tag for t in tracks]
        ids = [t.id for t in tracks]
        return str(meta_file), tags, ids, batch.windows, batch.track_index
    except Exception:
        log.error("Could not process %s", meta_file, exc_info=True)
        return None


def aggregate_strong_track(track_probs: np.ndarray, none_i: int,
                           threshold: float) -> tuple[int, int, int]:
    """The reference's three per-track decisions (audiomodel.py:1888-1933):
    argmax of the max/mean aggregate gated at the threshold, and the
    count-vote (per-window argmax over threshold, most frequent wins; the
    reference's tie check is a no-op — ``len(np.where(...))`` is always 1 —
    so ties fall to the first maximum, reproduced here via argmax)."""
    max_agg = track_probs.max(axis=0)
    max_pred = int(max_agg.argmax()) if max_agg.max() > threshold else none_i

    mean_agg = track_probs.mean(axis=0)
    mean_pred = int(mean_agg.argmax()) if mean_agg.max() > threshold else none_i

    arg_max = track_probs.argmax(axis=1)
    prob_max = track_probs[np.arange(len(track_probs)), arg_max]
    over = arg_max[prob_max > threshold]
    if len(over) == 0:
        counts_pred = none_i
    else:
        counts_pred = int(np.bincount(over).argmax())
    return mean_pred, max_pred, counts_pred


@dataclass
class StrongEvalResult:
    labels: list[str]
    mean_cm: np.ndarray
    max_cm: np.ndarray
    counts_cm: np.ndarray
    y_true: list[int] = field(default_factory=list)
    track_ids: list = field(default_factory=list)


def evaluate_strong_dir(
    predictor,
    dir_name: str | Path,
    out_prefix: str | Path | None = None,
    threshold: float = 0.7,
    workers: int = 1,
    remapped_labels: dict[str, int] | None = None,
    ontology: Ontology | None = None,
    rec_ids: list[int] | None = None,
) -> StrongEvalResult:
    """Evaluate every sidecar-labelled recording under ``dir_name``.

    ``rec_ids`` filters to ``<rec_id>-*.txt`` files whose id is listed
    (audiomodel.py:1829-1841).  ``workers > 1`` decodes/windows files in a
    spawn pool while the main process keeps the card busy.
    """
    dir_name = Path(dir_name)
    cfg = predictor.cfg
    labels, include_labels, remap = build_eval_label_space(
        list(predictor.labels), remapped_labels, ontology
    )
    none_i = len(labels) - 1

    meta_files = sorted(dir_name.glob("**/*.txt"))
    if rec_ids is not None:
        wanted = set(int(r) for r in rec_ids)
        filtered = []
        for f in meta_files:
            head = f.stem.split("-")[0]
            try:
                if int(head) in wanted:
                    filtered.append(f)
            except ValueError:
                continue
        meta_files = filtered
    log.info("Evaluating %s recordings from %s", len(meta_files), dir_name)

    work = [
        (str(f), include_labels, cfg.sr, cfg.segment_length,
         cfg.segment_stride, cfg.fmin, cfg.fmax)
        for f in meta_files
    ]
    if workers > 1:
        import multiprocessing as mp

        pool = mp.get_context("spawn").Pool(processes=workers)
        results_iter = pool.imap_unordered(preprocess_strong_file, work,
                                           chunksize=8)
    else:
        pool = None
        results_iter = map(preprocess_strong_file, work)

    y_true: list[int] = []
    predicted_mean: list[int] = []
    predicted_max: list[int] = []
    predicted_counts: list[int] = []
    confidences: list[np.ndarray] = []
    all_pred_confidences: list[np.ndarray] = []
    track_ids: list = []
    try:
        for count, result in enumerate(results_iter):
            if count % 100 == 0:
                log.info("Done %s / %s", count, len(meta_files))
            if result is None:
                continue
            meta_file, tags, ids, windows, track_index = result
            probs = predictor.predict_windows(windows)
            for ti, (tag, track_id) in enumerate(zip(tags, ids)):
                mask = track_index == ti
                if not mask.any():
                    continue
                track_probs = probs[mask]
                mean_pred, max_pred, counts_pred = aggregate_strong_track(
                    track_probs, none_i, threshold
                )
                predicted_mean.append(mean_pred)
                predicted_max.append(max_pred)
                predicted_counts.append(counts_pred)
                confidences.append(track_probs.mean(axis=0))
                all_pred_confidences.append(track_probs)
                track_ids.append(track_id)
                y_true.append(remap.get(tag, labels.index(tag)
                                        if tag in labels else none_i))
    finally:
        if pool is not None:
            pool.close()
            pool.join()

    n = len(labels)
    mean_cm = confusion_matrix(y_true, predicted_mean, n)
    max_cm = confusion_matrix(y_true, predicted_max, n)
    counts_cm = confusion_matrix(y_true, predicted_counts, n)

    if out_prefix is not None:
        out_prefix = Path(out_prefix)
        out_prefix.parent.mkdir(parents=True, exist_ok=True)
        # raw dump layout matches audiomodel.py:1943-1951 (stacked np.save)
        with (out_prefix.parent / f"{out_prefix.name}-raw.npy").open("wb") as f:
            np.save(f, np.array(track_ids))
            np.save(f, np.array(y_true))
            np.save(f, np.array(predicted_mean))
            np.save(f, np.array(confidences))
            np.save(f, np.array(labels))
        with (out_prefix.parent /
              f"{out_prefix.name}-raw-confidences.pkl").open("wb") as f:
            pickle.dump(all_pred_confidences, f)
        for name, cm in (("mean", mean_cm), ("max", max_cm),
                         ("counts", counts_cm)):
            save_confusion(cm, labels,
                           out_prefix.parent / f"{out_prefix.name}-{name}")
    return StrongEvalResult(labels=labels, mean_cm=mean_cm, max_cm=max_cm,
                            counts_cm=counts_cm, y_true=y_true,
                            track_ids=track_ids)
