"""Offline metadata enrichment: per-track band-limited RMS arrays and
signal spans (otherdata.py:1047-1396 capability parity; a copy of
``audio_training_tpu/corpus/enrich.py`` with the port's imports, and its
worker processes spawned, see :func:`enrich_folder`).

These sidecar-metadata additions are what the corpus model's RMS
tighten/filter (audiodataset.Track.tighten_track) and signal-percent logic
consume.  Bands: noise <500 Hz, bird >=500 Hz (species-specific caps for
bittern/morepork), upper >3 kHz broadband reference.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.corpus.audioio import load_recording
from audio_training_tpu_torch.corpus.dataset import Track
from audio_training_tpu_torch.detect.signals import _host_stft_mag, signal_noise

log = logging.getLogger(__name__)

N_FFT = 4096
HOP = 281

MIN_NOISE_MAX_FREQ = 100  # bittern band floor
NOISE_MAX_FREQ = 500
MOREPORK_MAX_FREQ = 1200
BITTERN_MAX_FREQ = 500
UPPER_MAX_FREQ = 3000


def band_rms(mag: np.ndarray, lo_bin: int | None, hi_bin: int | None,
             n_fft: int = N_FFT) -> np.ndarray:
    """Per-frame RMS of a band-limited magnitude spectrogram (equivalent of
    zeroing stft rows then librosa.feature.rms, otherdata.py:1242-1275).

    Parseval: mean(x^2) over a frame equals (|X0|^2 + 2*sum|Xk|^2 +
    |X_N/2|^2) / N^2 for a one-sided spectrum.
    """
    power = mag.astype(np.float64) ** 2
    weights = np.full(power.shape[0], 2.0)
    weights[0] = 1.0
    weights[-1] = 1.0
    if lo_bin is not None:
        power[:lo_bin] = 0
    if hi_bin is not None:
        power[hi_bin:] = 0
    energy = (power * weights[:, None]).sum(axis=0)
    return np.sqrt(energy / (n_fft**2))


def add_rms_data_to_tracks(y: np.ndarray, sr: int, tracks: list[dict]) -> None:
    """Attach upper/noise/bird RMS arrays to raw track metadata dicts
    (otherdata.add_rms_data_to_tracks, otherdata.py:1198-1279)."""
    freqs = np.linspace(0, sr / 2, 1 + N_FFT // 2)
    min_noise_bin = int(np.searchsorted(freqs, MIN_NOISE_MAX_FREQ) - 1)
    lower_noise_bin = int(np.searchsorted(freqs, NOISE_MAX_FREQ) - 1)
    morepork_upper_bin = int(np.searchsorted(freqs, MOREPORK_MAX_FREQ))
    bittern_upper_bin = int(np.searchsorted(freqs, BITTERN_MAX_FREQ))
    upper_noise_bin = int(np.searchsorted(freqs, UPPER_MAX_FREQ, "right"))

    for t in tracks:
        track = Track(t, None, 0, None, tighten=False, filter_rms=False)
        frames = y[int(sr * track.start) : int(sr * track.end)]
        if frames.size < N_FFT:
            frames = np.pad(frames, (0, N_FFT - frames.size))
        mag = _host_stft_mag(frames, N_FFT, HOP)

        noise_rms = band_rms(mag, None, lower_noise_bin + 1)
        upper_rms = band_rms(mag, upper_noise_bin, None)
        t["upper_noise_bin"] = upper_noise_bin

        lower_bin = lower_noise_bin
        upper_bin = None
        if "ausbit1" in track.human_tags:
            upper_bin = bittern_upper_bin
            lower_bin = min_noise_bin
        if "morepo2" in track.human_tags:
            upper_bin = morepork_upper_bin
        t["lower_nose_bin"] = lower_bin + 1
        t["bird_rms_bin"] = (
            [lower_bin + 1, upper_bin] if upper_bin is not None
            else [lower_bin + 1]
        )
        bird_rms = band_rms(mag, lower_bin, upper_bin)
        t["upper_rms"] = upper_rms.tolist()
        t["noise_rms"] = noise_rms.tolist()
        t["bird_rms"] = bird_rms.tolist()
        t["rms_hop_length"] = HOP
        t["rms_sr"] = sr


def process_rms(metadata_file: str | Path, target_sr: int = 48000) -> bool:
    """Enrich one sidecar file in place (otherdata.process_rms,
    otherdata.py:1153-1195)."""
    metadata_file = Path(metadata_file).with_suffix(".txt")
    try:
        meta = (
            json.loads(metadata_file.read_text())
            if metadata_file.exists() else {}
        )
        audio = None
        for suffix in (".m4a", ".wav", ".mp3", ".flac"):
            cand = metadata_file.with_suffix(suffix)
            if cand.exists():
                audio = cand
                break
        if audio is None:
            return False
        tracks = meta.get("Tracks", [])
        if any("upper_rms" in t for t in tracks):
            return False  # already enriched
        y, sr = load_recording(audio, target_sr=target_sr)
        add_rms_data_to_tracks(y, sr, tracks)
        meta["file"] = str(audio)
        meta["rms_version"] = 1.1
        metadata_file.write_text(json.dumps(meta, indent=4))
        return True
    except Exception:
        log.error("Error processing %s", metadata_file, exc_info=True)
        return False


def add_signal_meta(metadata_file: str | Path, target_sr: int = 48000) -> bool:
    """Attach detected signal spans [start, end, freq_lo, freq_hi] to the
    sidecar (otherdata.add_signal_meta / process_signal,
    otherdata.py:1282-1395)."""
    metadata_file = Path(metadata_file).with_suffix(".txt")
    try:
        meta = (
            json.loads(metadata_file.read_text())
            if metadata_file.exists() else {}
        )
        if "signal" in meta:
            return False
        audio = None
        for suffix in (".m4a", ".wav", ".mp3", ".flac"):
            cand = metadata_file.with_suffix(suffix)
            if cand.exists():
                audio = cand
                break
        if audio is None:
            return False
        y, sr = load_recording(audio, target_sr=target_sr)
        signals, _ = signal_noise(y, sr)
        meta["signal"] = [
            [s.start, s.end, s.freq_start, s.freq_end] for s in signals
        ]
        meta["signal_version"] = 1
        metadata_file.write_text(json.dumps(meta, indent=4))
        return True
    except Exception:
        log.error("Error adding signal meta to %s", metadata_file,
                  exc_info=True)
        return False


def generate_tracks(metadata_file: str | Path, target_sr: int = 48000,
                    segment_length: float = 3.0) -> bool:
    """Score the best 3 s segment per detected signal region and write track
    entries for untracked recordings (otherdata.generate_tracks,
    otherdata.py:1442-1545 capability)."""
    from audio_training_tpu_torch.detect.signals import get_end, get_tracks_from_signals

    metadata_file = Path(metadata_file).with_suffix(".txt")
    try:
        meta = (
            json.loads(metadata_file.read_text())
            if metadata_file.exists() else {}
        )
        if meta.get("Tracks"):
            return False
        audio = None
        for suffix in (".m4a", ".wav", ".mp3", ".flac"):
            cand = metadata_file.with_suffix(suffix)
            if cand.exists():
                audio = cand
                break
        if audio is None:
            return False
        y, sr = load_recording(audio, target_sr=target_sr)
        end = get_end(y, sr)
        signals, _ = signal_noise(y, sr)
        tracks = get_tracks_from_signals(signals, end)
        label = meta.get("label")
        meta["Tracks"] = [
            {
                "id": f"gen-{i}",
                "start": t.start,
                "end": t.end,
                "minFreq": t.freq_start,
                "maxFreq": t.freq_end,
                "automatic": True,
                "tags": (
                    [{"what": label, "automatic": False}] if label else []
                ),
            }
            for i, t in enumerate(tracks)
        ]
        metadata_file.write_text(json.dumps(meta, indent=4))
        return True
    except Exception:
        log.error("Error generating tracks for %s", metadata_file,
                  exc_info=True)
        return False


def _enrich_one(args) -> int:
    f, rms, signal, gen_tracks, best_track = args
    n = 0
    if gen_tracks and generate_tracks(f):
        n += 1
    if rms and process_rms(f):
        n += 1
    if signal and add_signal_meta(f):
        n += 1
    if best_track and generate_best_track(f):
        n += 1
    return n


def enrich_folder(folder: str | Path, rms: bool = True, signal: bool = True,
                  gen_tracks: bool = False, best_track: bool = False,
                  workers: int = 1) -> int:
    """Run enrichment over every sidecar in a tree (the reference drives
    this with an 8-proc pool, otherdata.py:1073-1074).  ``best_track``
    adds the weak-label best-3s annotation (needs ``signal`` spans, which
    run first in the same pass)."""
    jobs = [(f, rms, signal, gen_tracks, best_track)
            for f in sorted(Path(folder).glob("**/*.txt"))]
    if workers <= 1:
        return sum(_enrich_one(j) for j in jobs)
    import multiprocessing

    # spawn, not fork (the JAX package forks), as corpus/writer.py does:
    # the caller may hold a CUDA context and live threads.  A spawned
    # worker imports this module, and its chain (corpus/audioio,
    # corpus/dataset, detect/signals and the record format) is numpy and
    # scipy alone: the worker starts without torch.  ``gen_tracks`` is the
    # exception: ``get_end`` imports ``ops``, and with it torch.  Workers
    # re-import the main module as ``__mp_main__``, so a script that
    # enriches keeps its body under ``if __name__ == "__main__"``.
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        return sum(pool.map(_enrich_one, jobs))


def signal_length_for_segment(tracks, s_start: float, s_end: float) -> float:
    """Total in-segment signal time (otherdata.signal_length_for_segment,
    otherdata.py:1548-1557 — exact port incl. the reference's skip
    condition comparing ``s.end`` against the segment END, and the early
    break relying on start-sorted tracks)."""
    signal_length = 0.0
    for s in tracks:
        if s.start < s_start and s.end < s_end:
            continue
        if s.start > s_end:
            break
        signal_length += min(s.end, s_end) - max(s_start, s.start)
    return signal_length


def best_segment_from_tracks(tracks, end: float, segment_length: float = 3.0,
                             step: float = 0.5):
    """Best ``segment_length``-second window by smoothed signal coverage
    (otherdata.generate_tracks scoring loop, otherdata.py:1488-1517):
    score(t) = len(t-1) + len(t) for the second window and
    len(t-1) + (len(t) + len(t-2))/2 after, recorded at start t-1 — the
    reference's one-window-lagged smoothing, ported as-is.

    Returns (start, signal_length, score)."""
    length_per_segment: list[float] = []
    best_segment = (0.0, 0.0, 0.0)
    n_starts = max(int(end) - int(segment_length) + 1, 1)
    for start in np.arange(n_starts, step=step):
        sl = signal_length_for_segment(tracks, start, start + segment_length)
        if length_per_segment:
            score = length_per_segment[-1]
            if len(length_per_segment) == 1:
                score += sl
            else:
                score += (sl + length_per_segment[-2]) / 2
            if best_segment[2] < score:
                best_segment = (float(start - step), sl, score)
        else:
            best_segment = (float(start), sl, sl)
        length_per_segment.append(sl)
    return best_segment


def generate_best_track(metadata_file: str | Path, label: str | None = None,
                        segment_length: float = 3.0) -> bool:
    """Write the ``best_track`` sidecar entry that strong-label folder
    evaluation consumes (otherdata.generate_tracks, otherdata.py:1442-1545;
    consumed by audiomodel.evaluate_dir / predict.predict_on_folder —
    here infer/folder.py).

    Requires stored ``signal`` spans (run :func:`add_signal_meta` first,
    as the reference's pipeline does).  Signal spans narrower than
    ``min_width`` in TIME or FREQUENCY are dropped — the reference defines
    a separate ``min_height`` but filters both axes with ``min_width``
    (otherdata.py:1451-1452, :1477), preserved as-is.
    """
    from audio_training_tpu_torch.detect.signals import (
        Signal,
        get_tracks_from_signals,
    )

    min_width = 0.15981875
    metadata_file = Path(metadata_file).with_suffix(".txt")
    try:
        if not metadata_file.exists():
            return False
        meta = json.loads(metadata_file.read_text())
        if "signal" not in meta:
            log.error("No signal metadata for %s (run add_signal_meta)",
                      metadata_file)
            return False
        end = meta.get("rec_end")
        signals = []
        sig_end = None
        for s in meta["signal"]:
            if (s[1] - s[0]) < min_width or (s[3] - s[2]) < min_width:
                continue
            signals.append(Signal(s[0], s[1], s[2], s[3], 0))
            if end is None and (sig_end is None or s[1] > sig_end):
                sig_end = s[1]
        if end is None:
            if sig_end is None:
                return False
            end = sig_end + segment_length
        tracks = get_tracks_from_signals(signals, end, filter_short=False)
        start, sig_len, score = best_segment_from_tracks(
            tracks, end, segment_length
        )
        if label is None:
            label = meta.get("label") or metadata_file.parent.name
        meta["best_track"] = {
            "score": score,
            "signal_length": sig_len,
            "start": start,
            "end": start + segment_length,
            "tags": [{"automatic": False, "what": label}],
        }
        metadata_file.write_text(json.dumps(meta, indent=4))
        return True
    except Exception:
        log.error("Error generating best track for %s", metadata_file,
                  exc_info=True)
        return False


def analyze_rms(metadata_file: str | Path,
                min_stddev_percent: float = 0.15) -> list[dict]:
    """Per-track RMS quality report (otherdata.analyze_rms,
    otherdata.py:1077-1151): peak-matched noise removal over the stored
    bird/noise/upper band-RMS arrays, the low-stddev flatness flag (the
    reference logs tracks whose std/mean < 0.15 as suspect), and the
    best-3 s-window offset.  Bird-tagged tracks analyze ``bird_rms``
    against ``noise_rms``; others the reverse.  Returns one dict per
    analyzable track instead of log lines."""
    import scipy.signal

    from audio_training_tpu_torch.corpus.dataset import best_rms, remove_rms_noise
    from audio_training_tpu_torch.taxonomy.ebird import get_ebird_id
    from audio_training_tpu_torch.taxonomy.ontology import load_ontology

    metadata_file = Path(metadata_file).with_suffix(".txt")
    if not metadata_file.exists():
        log.error("No metadata for %s", metadata_file)
        return []
    meta = json.loads(metadata_file.read_text())
    all_birds = set(load_ontology().all_birds)
    rms_thresh = 0.00001
    rms_height = 0.001
    out: list[dict] = []
    for t in meta.get("Tracks", []):
        tags = {tag.get("what") for tag in t.get("tags", [])
                if tag.get("what")}
        if not tags or any(k not in t for k in
                           ("bird_rms", "noise_rms", "upper_rms")):
            continue
        # the enrichment records the geometry it analyzed at
        # (add_rms_data_to_tracks writes rms_sr/rms_hop_length)
        sr = int(t.get("rms_sr", 48000))
        hop = int(t.get("rms_hop_length", 281))
        upper_peaks, _ = scipy.signal.find_peaks(
            np.asarray(t["upper_rms"], np.float64),
            threshold=rms_thresh / 10, height=rms_height / 10, width=2,
        )
        # sidecar tags are common names; the ontology's bird set holds
        # eBird ids (+ a few curated labels) — check both forms
        bird = any(
            tag in all_birds or (get_ebird_id(tag) or "") in all_birds
            for tag in tags
        )
        rms = np.asarray(t["bird_rms" if bird else "noise_rms"], np.float64)
        noise = np.asarray(t["noise_rms" if bird else "bird_rms"], np.float64)
        rms_peaks, rms_meta = scipy.signal.find_peaks(
            rms, threshold=rms_thresh, height=rms_height, width=2
        )
        noise_peaks, noise_meta = scipy.signal.find_peaks(
            noise, threshold=rms_thresh, height=rms_height, width=2
        )
        remove_rms_noise(rms, rms_peaks, rms_meta, noise_peaks, noise_meta,
                         upper_peaks, sr=sr, hop_length=hop)
        mean = float(np.mean(rms))
        std = float(np.std(rms))
        pct = std / mean if mean else 0.0
        best_offset, best_sum = best_rms(rms, sr=sr, hop_length=hop)
        out.append({
            "track_id": t.get("id"),
            "tags": sorted(tags),
            "used": "bird_rms" if bird else "noise_rms",
            "stddev_percent": pct,
            "low_stddev": pct < min_stddev_percent,
            "best_offset_s": round(best_offset * hop / sr, 2),
            "best_sum": float(best_sum),
        })
    return out
