"""Small corpus utilities — parity with the reference's standalone scripts:
audiosplitter.py (long-file chunking), audiometadata.py (anonymized export),
audiodatabase.py (lock-guarded HDF5 store), labelstoebird.py
(label bookkeeping).

A copy of ``audio_training_tpu/corpus/tools.py`` with the port's imports.
"""

from __future__ import annotations

import json
import logging
import shutil
import uuid
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.corpus.audioio import load_recording, save_wav
from audio_training_tpu_torch.taxonomy.ebird import (
    get_ebird_id,
    get_ebird_ids_to_labels,
    get_label_to_ebird_map,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# audiosplitter.py: split long files into 1-minute chunks (+copy metadata)
# ---------------------------------------------------------------------------


def split_audio_files(
    in_dir: str | Path,
    out_dir: str | Path,
    chunk_seconds: float = 60.0,
    target_sr: int | None = None,
) -> int:
    """Split every audio file into fixed chunks with per-chunk sidecars
    (audiosplitter.py:28-75)."""
    in_dir = Path(in_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for audio in sorted(in_dir.iterdir()):
        if audio.suffix.lower() not in (".wav", ".mp3", ".m4a", ".flac"):
            continue
        try:
            frames, sr = load_recording(audio, target_sr=target_sr)
        except Exception:
            log.warning("could not decode %s", audio, exc_info=True)
            continue
        sidecar = audio.with_suffix(".txt")
        meta = json.loads(sidecar.read_text()) if sidecar.exists() else {}
        chunk = int(chunk_seconds * sr)
        for i, start in enumerate(range(0, len(frames), chunk)):
            piece = frames[start : start + chunk]
            if len(piece) < sr:  # skip sub-second tails
                continue
            out_audio = out_dir / f"{audio.stem}-{i:03d}.wav"
            save_wav(out_audio, piece, sr)
            piece_meta = dict(meta)
            piece_meta["id"] = f"{meta.get('id', audio.stem)}-{i:03d}"
            piece_meta["duration"] = len(piece) / sr
            piece_meta["chunk_of"] = str(audio.name)
            piece_meta["chunk_start"] = start / sr
            out_audio.with_suffix(".txt").write_text(
                json.dumps(piece_meta, indent=2)
            )
            n += 1
    return n


# ---------------------------------------------------------------------------
# audiometadata.py: anonymized per-recording metadata export
# ---------------------------------------------------------------------------


def export_anonymized_metadata(
    corpus_dir: str | Path, out_dir: str | Path, fuzz_degrees: float = 0.1
) -> int:
    """Fuzzy-GPS anonymized export (audiometadata.main, audiometadata.py:43-88):
    locations rounded to ``fuzz_degrees``, device/group ids replaced by
    stable opaque UIDs."""
    corpus_dir = Path(corpus_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    uid_map: dict[str, str] = {}

    def uid(key) -> str | None:
        if key is None:
            return None
        key = str(key)
        if key not in uid_map:
            uid_map[key] = uuid.uuid5(uuid.NAMESPACE_OID, key).hex[:12]
        return uid_map[key]

    n = 0
    for f in sorted(corpus_dir.glob("**/*.txt")):
        try:
            meta = json.loads(f.read_text())
        except Exception:
            continue
        location = meta.get("location")
        fuzzed = None
        if location:
            if isinstance(location, list):
                location = location[0]
            lat, lng = location.get("lat"), location.get("lng")
            if lat is not None and lng is not None:
                fuzzed = {
                    "lat": round(lat / fuzz_degrees) * fuzz_degrees,
                    "lng": round(lng / fuzz_degrees) * fuzz_degrees,
                }
        out = {
            "id": meta.get("id"),
            "duration": meta.get("duration"),
            "recordingDateTime": meta.get("recordingDateTime"),
            "location": fuzzed,
            "device_uid": uid(meta.get("deviceId")),
            "group_uid": uid(meta.get("groupId")),
            "tracks": [
                {
                    "start": t.get("start"),
                    "end": t.get("end"),
                    "tags": [tag.get("what") for tag in t.get("tags", [])],
                }
                for t in (meta.get("Tracks") or meta.get("tracks", []))
            ],
        }
        (out_dir / f"{meta.get('id', f.stem)}.json").write_text(
            json.dumps(out, indent=2)
        )
        n += 1
    return n


# ---------------------------------------------------------------------------
# audiodatabase.py: lock-guarded HDF5 recording store
# ---------------------------------------------------------------------------


class AudioDatabase:
    """HDF5 store with a file lock (audiodatabase.AudioDatabase,
    audiodatabase.py:30-90 — the reference only implements ``has_rec``;
    here add/get are functional too)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.lock_path = str(self.path) + ".lock"

    def _open(self, mode="r"):
        import h5py
        from filelock import FileLock

        lock = FileLock(self.lock_path, timeout=30)
        lock.acquire()
        try:
            f = h5py.File(self.path, mode)
        except Exception:
            lock.release()
            raise
        return f, lock

    def has_rec(self, rec_id) -> bool:
        if not self.path.exists():
            return False
        f, lock = self._open("r")
        try:
            return str(rec_id) in f
        finally:
            f.close()
            lock.release()

    def add_rec(self, rec_id, frames: np.ndarray, sr: int,
                metadata: dict | None = None) -> None:
        f, lock = self._open("a")
        try:
            if str(rec_id) in f:
                del f[str(rec_id)]
            g = f.create_group(str(rec_id))
            g.create_dataset("frames", data=np.asarray(frames, np.float32),
                             compression="gzip")
            g.attrs["sr"] = sr
            if metadata:
                g.attrs["metadata"] = json.dumps(metadata)
        finally:
            f.close()
            lock.release()

    def get_rec(self, rec_id):
        f, lock = self._open("r")
        try:
            g = f[str(rec_id)]
            meta = json.loads(g.attrs.get("metadata", "{}"))
            return np.asarray(g["frames"]), int(g.attrs["sr"]), meta
        finally:
            f.close()
            lock.release()


# ---------------------------------------------------------------------------
# labelstoebird.py: label bookkeeping / diff utilities
# ---------------------------------------------------------------------------


def labels_to_api_names(labels: list[str],
                        label_paths: dict | None = None) -> list[str]:
    """eBird ids -> API display names (labelstoebird.labels_to_api,
    labelstoebird.py:218)."""
    id_map = get_ebird_ids_to_labels()
    hyphenated = {}
    if label_paths:
        for lbl in label_paths:
            hyphenated[lbl.replace(" ", "-")] = lbl
    out = []
    for l in labels:
        candidates = id_map.get(l, [l])
        match = next((hyphenated[c] for c in candidates if c in hyphenated),
                     None)
        out.append(match or candidates[0])
    return out


def label_set_diff(first: list[str], second: list[str]) -> dict:
    """Which labels differ between two models (labelstoebird.py label-diff
    utilities)."""
    f, s = set(first), set(second)
    return {"only_first": sorted(f - s), "only_second": sorted(s - f),
            "common": sorted(f & s)}


def counts_vs_accuracy(
    labels: list[str], counts: dict[str, int], cm: np.ndarray,
) -> list[dict]:
    """Training-count vs per-label accuracy table
    (labelstoebird.graph_counts_vs_accuracy, labelstoebird.py:338)."""
    rows = []
    for i, l in enumerate(labels):
        total = int(cm[i].sum()) if i < len(cm) else 0
        correct = int(cm[i][i]) if i < len(cm) else 0
        rows.append({
            "label": l,
            "train_count": counts.get(l, 0),
            "accuracy": correct / total if total else None,
        })
    return rows
