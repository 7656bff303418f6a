"""Signal-region dataset tooling (build.py's two signal modes; a copy of
``audio_training_tpu/corpus/signal_data.py`` with the port's imports).

* :func:`export_signal_data` — ``--create-signal-wavs``
  (build.create_signal_data, build.py:840-912): per tag-key, concatenate
  the audio inside detected signal spans that overlap each track into
  chunked WAVs plus a JSON index mapping recording/track ids to sample
  offsets.  Used to distill a corpus down to its vocalization audio.
* :func:`build_signal_dataset` — ``--signal``
  (build.dataset_from_signal, build.py:248-330): ingest a pre-split
  ``{train,validation,test}/<label>-<n>.wav`` signal-WAV tree (the output
  of the exporter, manually curated) into TFRecord shards +
  training-meta.json.  The label is the filename stem up to the last "-".

Reference-fix note (convention: reference bugs fixed by default,
documented at the site): the reference creates ONE AudioSample per signal
file with ``end=None`` — its writer then only ever reads the first 3 s of
each (often minutes-long) file.  Here each file gets the standard
per-track jittered sampling over its FULL length.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.config import FeaturizerConfig, SamplingConfig
from audio_training_tpu_torch.corpus.audioio import (
    load_recording,
    probe_duration,
    save_wav,
)
from audio_training_tpu_torch.corpus.dataset import (
    AUDIO_SUFFIXES,
    AudioDataset,
    Recording,
)
from audio_training_tpu_torch.corpus.split import write_training_meta
from audio_training_tpu_torch.corpus.writer import create_tf_records

log = logging.getLogger(__name__)


def _track_signal_audio(rec, track, frames: np.ndarray, sr: int) -> np.ndarray:
    """Concatenated samples of every (spaced) signal span overlapping the
    track (build.py:856-872; spans sorted, early-break once past the
    track)."""
    parts = []
    for s in rec.signals:
        overlaps = (
            (track.end - track.start) + (s[1] - s[0])
            > max(track.end, s[1]) - min(track.start, s[0])
        )
        if overlaps:
            t_s = math.floor(max(s[0], track.start) * sr)
            t_e = math.ceil(min(s[1], track.end) * sr)
            parts.append(frames[t_s:t_e])
        elif s[0] > track.start:
            break
    if not parts:
        return np.empty(0, np.float32)
    return np.concatenate(parts)


def export_signal_data(
    dataset: AudioDataset,
    output_path: str | Path,
    sr: int = 48000,
    min_seconds: float = 10.0,
    clear: bool = True,
) -> int:
    """Write per-tag-key signal-audio chunks; returns files written."""
    output_path = Path(output_path)
    if clear and output_path.is_dir():
        log.info("Clearing %s", output_path)
        for child in output_path.glob("*"):
            if child.is_file():
                child.unlink()
    output_path.mkdir(parents=True, exist_ok=True)

    # key -> [chunk_counter, sample list, {"recs": {rec: {track: [s, e]}}}]
    acc: dict[str, list] = {}
    written = 0

    def flush(key: str, force: bool) -> int:
        counter, data, meta = acc[key]
        n_samples = sum(len(d) for d in data)
        if not data or (not force and n_samples <= sr * min_seconds):
            return 0
        chunk = np.concatenate(data).astype(np.float32)
        save_wav(output_path / f"{key}-{counter}.wav", chunk, sr)
        (output_path / f"{key}-{counter}.txt").write_text(
            json.dumps(meta, indent=4)
        )
        acc[key] = [counter + 1, [], {"recs": {}}]
        return 1

    for rec in dataset.recs.values():
        rec.space_signals()
        try:
            frames, _sr = load_recording(rec.filename, target_sr=sr)
        except Exception:
            log.warning("could not load %s", rec.filename, exc_info=True)
            continue
        for track in rec.tracks:
            audio = _track_signal_audio(rec, track, frames, sr)
            if audio.size == 0:
                continue
            key = track.tags_key
            if key not in acc:
                acc[key] = [1, [], {"recs": {}}]
            counter, data, meta = acc[key]
            offset = sum(len(d) for d in data)
            data.append(audio)
            rec_meta = meta["recs"].setdefault(str(rec.id), {})
            rec_meta[str(track.id)] = [offset, offset + len(audio)]
        for key in list(acc):
            written += flush(key, force=False)
    for key in list(acc):
        written += flush(key, force=True)
    return written


def build_signal_dataset(
    signal_dir: str | Path,
    out_dir: str | Path | None = None,
    sampling: SamplingConfig | None = None,
    featurizer: FeaturizerConfig | None = None,
    num_workers: int = 2,
    shards_per_worker: int = 2,
) -> Path:
    """Signal-WAV tree -> TFRecord shards (build.dataset_from_signal)."""
    signal_dir = Path(signal_dir)
    out = Path(out_dir) if out_dir is not None else signal_dir
    out = out / "training-data"
    sampling = sampling or SamplingConfig(tighten_tracks=False,
                                          filter_rms=False)
    featurizer = featurizer or FeaturizerConfig()

    datasets: list[AudioDataset] = []
    all_labels: set[str] = set()
    rec_id = 0
    track_id = 0
    for split in ("train", "validation", "test"):
        set_dir = signal_dir / split
        ds = AudioDataset(split, sampling,
                          segment_length=featurizer.segment_length,
                          segment_stride=featurizer.segment_stride)
        if set_dir.is_dir():
            for audio in sorted(set_dir.iterdir()):
                if audio.suffix.lower() not in AUDIO_SUFFIXES:
                    continue
                stem = audio.stem
                if "-" not in stem:
                    log.warning("no label prefix in %s; skipping", audio)
                    continue
                label = stem[: stem.rindex("-")]
                # header/probe duration only — create_tf_records decodes the
                # audio itself; a full decode here would read each (often
                # minutes-long) file twice per build
                duration = probe_duration(audio)
                if duration is None:
                    try:
                        frames, sr = load_recording(audio, target_sr=None)
                        duration = len(frames) / sr
                    except Exception:
                        log.warning("could not load %s", audio,
                                    exc_info=True)
                        continue
                rec_id += 1
                track_id += 1
                meta = {
                    "id": rec_id,
                    "duration": duration,
                    "Tracks": [{
                        "id": track_id,
                        "start": 0,
                        "end": duration,
                        "tags": [{"what": label, "automatic": False}],
                    }],
                }
                rec = Recording(
                    meta, audio, sampling,
                    segment_length=featurizer.segment_length,
                    segment_stride=featurizer.segment_stride,
                )
                ds.add_recording(rec)
        datasets.append(ds)
        all_labels.update(ds.labels)

    labels = sorted(all_labels)
    for ds in datasets:
        ds.labels = set(labels)
        n = create_tf_records(
            ds, out / ds.name, num_workers=num_workers,
            shards_per_worker=shards_per_worker, cfg=featurizer,
        )
        log.info("signal dataset %s: %s records", ds.name, n)
    write_training_meta(out, datasets, featurizer)
    return out
