"""External-corpus ingestion (otherdata.py capability parity).

Each ingestor converts an external dataset layout into the framework's
canonical form — ``{audio file + sidecar .txt JSON}`` trees that
``AudioDataset.load_meta`` consumes:

* :func:`csv_dataset` — CSV-driven corpora (ESC-50 / FSDnoisy / ambient
  style: filename,label columns; otherdata.csv_dataset, otherdata.py:378-442)
* :func:`tier1_data` — DCASE-Tier1/BirdCLEF-style strong-label CSVs with
  onset/offset rows (otherdata.tier1_data, otherdata.py:759-960)
* :func:`folder_dataset` — weakly-labelled folder-per-label trees
  (otherdata.weakly_lbled_data, otherdata.py:285-353)
* :func:`flickr_data` — speech corpora ingested as ``human``
  (otherdata.flickr_data, otherdata.py:488-572)
* :func:`chime_data` — CHiME-home chunks with multi-label annotations
  (otherdata.chime_data, otherdata.py:624-756)
* :func:`mix_noise` — background-noise augmentation mixing
  (otherdata.process_noise, otherdata.py:110-188; audiomentations replaced
  by a numpy SNR mixer)

A copy of ``audio_training_tpu/corpus/otherdata.py`` with the port's imports.
"""

from __future__ import annotations

import csv
import json
import logging
import shutil
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.corpus.audioio import load_recording, save_wav

log = logging.getLogger(__name__)


def _write_sidecar(audio_file: Path, rec_id: str, tracks: list[dict],
                   duration: float | None = None, **extra) -> Path:
    meta = {"id": rec_id, "duration": duration, "Tracks": tracks}
    meta.update(extra)
    out = audio_file.with_suffix(".txt")
    out.write_text(json.dumps(meta, indent=2))
    return out


def _full_track(rec_id: str, label: str, duration: float) -> dict:
    return {
        "id": f"{rec_id}-t0",
        "start": 0,
        "end": duration,
        "tags": [{"what": label, "automatic": False}],
    }


def csv_dataset(
    csv_file: str | Path,
    audio_dir: str | Path,
    out_dir: str | Path,
    file_col: str = "filename",
    label_col: str = "category",
    id_prefix: str = "csv",
    copy_audio: bool = True,
) -> int:
    """Ingest a (filename, label) CSV corpus (otherdata.py:378-442)."""
    audio_dir = Path(audio_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(csv_file, newline="") as f:
        for row in csv.DictReader(f):
            src = audio_dir / row[file_col]
            if not src.exists():
                log.warning("missing audio %s", src)
                continue
            rec_id = f"{id_prefix}-{src.stem}"
            dst = out_dir / src.name
            if copy_audio and not dst.exists():
                shutil.copyfile(src, dst)
            try:
                frames, sr = load_recording(dst if copy_audio else src,
                                            target_sr=None)
                duration = len(frames) / sr
            except Exception:
                log.warning("could not decode %s", src, exc_info=True)
                continue
            _write_sidecar(
                dst if copy_audio else src, rec_id,
                [_full_track(rec_id, row[label_col], duration)],
                duration=duration,
            )
            n += 1
    return n


def tier1_data(
    annotations_csv: str | Path,
    audio_dir: str | Path,
    out_dir: str | Path,
    file_col: str = "Filename",
    label_col: str = "Label",
    start_col: str = "Starttime",
    end_col: str = "Endtime",
    id_prefix: str = "tier1",
) -> int:
    """Strong-label CSV with per-event onset/offset rows grouped by file
    (otherdata.tier1_data, otherdata.py:759-960)."""
    audio_dir = Path(audio_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    by_file: dict[str, list[dict]] = {}
    with open(annotations_csv, newline="") as f:
        for row in csv.DictReader(f):
            by_file.setdefault(row[file_col], []).append(row)
    n = 0
    for fname, rows in by_file.items():
        src = audio_dir / fname
        if not src.exists():
            log.warning("missing audio %s", src)
            continue
        rec_id = f"{id_prefix}-{src.stem}"
        dst = out_dir / src.name
        if not dst.exists():
            shutil.copyfile(src, dst)
        try:
            frames, sr = load_recording(dst, target_sr=None)
            duration = len(frames) / sr
        except Exception:
            continue
        tracks = [
            {
                "id": f"{rec_id}-t{i}",
                "start": float(r[start_col]),
                "end": float(r[end_col]),
                "tags": [{"what": r[label_col], "automatic": False}],
            }
            for i, r in enumerate(rows)
        ]
        _write_sidecar(dst, rec_id, tracks, duration=duration)
        n += 1
    return n


def folder_dataset(
    root: str | Path, out_dir: str | Path | None = None,
    id_prefix: str = "weak",
) -> int:
    """Folder-per-label weak labels: each file gets one full-length track
    (otherdata.weakly_lbled_data, otherdata.py:285-353)."""
    root = Path(root)
    n = 0
    for label_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        label = label_dir.name
        for audio in sorted(label_dir.iterdir()):
            if audio.suffix.lower() not in (".wav", ".mp3", ".m4a", ".flac"):
                continue
            try:
                frames, sr = load_recording(audio, target_sr=None)
                duration = len(frames) / sr
            except Exception:
                continue
            rec_id = f"{id_prefix}-{label}-{audio.stem}"
            _write_sidecar(audio, rec_id,
                           [_full_track(rec_id, label, duration)],
                           duration=duration)
            n += 1
    return n


def flickr_data(audio_dir: str | Path, id_prefix: str = "flickr") -> int:
    """Speech corpus ingested wholesale as ``human``
    (otherdata.flickr_data, otherdata.py:488-572)."""
    audio_dir = Path(audio_dir)
    n = 0
    for audio in sorted(audio_dir.glob("**/*")):
        if audio.suffix.lower() not in (".wav", ".mp3", ".m4a", ".flac"):
            continue
        try:
            frames, sr = load_recording(audio, target_sr=None)
            duration = len(frames) / sr
        except Exception:
            continue
        rec_id = f"{id_prefix}-{audio.stem}"
        _write_sidecar(audio, rec_id,
                       [_full_track(rec_id, "human", duration)],
                       duration=duration)
        n += 1
    return n


def chime_data(
    chunks_csv: str | Path, audio_dir: str | Path, id_prefix: str = "chime",
    label_map: dict[str, str] | None = None,
) -> int:
    """CHiME-home chunk annotations: majority-vote letters -> labels
    (otherdata.chime_data, otherdata.py:624-756).  Default letter map:
    c=child -> human, m/f=adult -> human, v=video/TV -> noise,
    p=percussive -> noise, b=broadband -> noise, o=other -> noise."""
    label_map = label_map or {
        "c": "human", "m": "human", "f": "human",
        "v": "noise", "p": "noise", "b": "noise", "o": "noise",
    }
    audio_dir = Path(audio_dir)
    n = 0
    with open(chunks_csv, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            chunk, letters = row[0], row[1]
            src = audio_dir / f"{chunk}.wav"
            if not src.exists():
                continue
            labels = sorted({label_map[c] for c in letters if c in label_map})
            if not labels:
                continue
            try:
                frames, sr = load_recording(src, target_sr=None)
                duration = len(frames) / sr
            except Exception:
                continue
            rec_id = f"{id_prefix}-{chunk}"
            tracks = [
                {
                    "id": f"{rec_id}-t{i}",
                    "start": 0,
                    "end": duration,
                    "tags": [{"what": l, "automatic": False}],
                }
                for i, l in enumerate(labels)
            ]
            _write_sidecar(src, rec_id, tracks, duration=duration)
            n += 1
    return n


def mix_noise(
    signal: np.ndarray,
    noise: np.ndarray,
    snr_db: float | tuple[float, float] = (3.0, 30.0),
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Mix background noise at a (random) SNR — numpy replacement for the
    audiomentations AddBackgroundNoise the reference uses
    (otherdata.process_noise, otherdata.py:110-188)."""
    rng = rng or np.random.default_rng()
    if isinstance(snr_db, tuple):
        snr_db = float(rng.uniform(*snr_db))
    if len(noise) < len(signal):
        reps = int(np.ceil(len(signal) / len(noise)))
        noise = np.tile(noise, reps)
    start = int(rng.integers(0, len(noise) - len(signal) + 1))
    noise = noise[start : start + len(signal)]
    sig_rms = np.sqrt(np.mean(signal**2)) + 1e-12
    noise_rms = np.sqrt(np.mean(noise**2)) + 1e-12
    gain = sig_rms / (noise_rms * 10 ** (snr_db / 20))
    return (signal + gain * noise).astype(np.float32)


def make_noise_mixed_copies(
    audio_dir: str | Path, noise_dir: str | Path, out_dir: str | Path,
    per_file: int = 1, target_sr: int = 48000, seed: int = 0,
) -> int:
    """Write noise-mixed copies of a corpus (with sidecars carried over)."""
    rng = np.random.default_rng(seed)
    audio_dir = Path(audio_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    noises = []
    for f in sorted(Path(noise_dir).glob("**/*.wav")):
        try:
            frames, _ = load_recording(f, target_sr=target_sr)
            noises.append(frames)
        except Exception:
            continue
    if not noises:
        return 0
    n = 0
    for audio in sorted(audio_dir.glob("*.wav")):
        sidecar = audio.with_suffix(".txt")
        try:
            frames, sr = load_recording(audio, target_sr=target_sr)
        except Exception:
            continue
        for k in range(per_file):
            noise = noises[int(rng.integers(0, len(noises)))]
            mixed = mix_noise(frames, noise, rng=rng)
            out_audio = out_dir / f"{audio.stem}-noise{k}.wav"
            save_wav(out_audio, mixed, sr)
            if sidecar.exists():
                meta = json.loads(sidecar.read_text())
                meta["id"] = f"{meta.get('id', audio.stem)}-noise{k}"
                out_audio.with_suffix(".txt").write_text(
                    json.dumps(meta, indent=2)
                )
            n += 1
    return n


def redo_csv(
    csv_in: str | Path,
    audio_dir: str | Path,
    csv_out: str | Path,
    duration_insert_at: int = 3,
) -> int:
    """Repair a badly-made corpus CSV (otherdata.redo_csv,
    otherdata.py:357-376): resolve each row's audio path against
    ``audio_dir``, probe the real duration and insert it as a new column.
    Rows whose audio is missing raise, like the reference ("FAILED")."""
    audio_dir = Path(audio_dir)
    n = 0
    with open(csv_in, newline="") as fin, \
            open(csv_out, "w", newline="") as fout:
        reader = csv.reader(fin, delimiter=",", quotechar="|")
        writer = csv.writer(fout, delimiter=",", quotechar="|")
        writer.writerow(next(reader))  # header passes through
        for row in reader:
            audio_file = audio_dir / row[0]
            if not audio_file.exists():
                raise FileNotFoundError(f"missing audio for row: {row}")
            frames, sr = load_recording(audio_file, target_sr=None)
            row[0] = str(audio_file)
            row.insert(duration_insert_at, len(frames) / sr)
            writer.writerow(row)
            n += 1
    return n
