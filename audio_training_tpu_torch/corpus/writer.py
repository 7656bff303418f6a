"""Multiprocess TFRecord shard writer (audiowriter.py parity; a copy of
``audio_training_tpu/corpus/writer.py`` with the port's imports).

Worker processes pull recordings off a queue, decode audio, slice per-sample
waveforms, and write GZIP shards round-robin (audiowriter.create_tf_records /
process_job, audiowriter.py:578-642, 239-311).

TPU-native change: the full 2049x513 magnitude spectrogram the reference
stores per record (~4 MB, audiowriter.py:131-135) is NOT written by default —
the training pipeline recomputes the STFT on device from the raw waveform in
microseconds, so records shrink ~8x and the host input pipeline reads ~8x
less gzip.  ``store_spectrogram=True`` restores byte-level schema parity.

The build is host code: the stored spectrogram's clip is min-max
normalized on a CPU tensor (the JAX package does it through XLA), and the
writer processes are spawned, never forked (see ``create_tf_records``).
There is no embedder: ``embedding_model`` names a TensorFlow saved model
(the JAX package's ``infer/embeddings.PerchModel``), so it raises.
"""

from __future__ import annotations

import logging
import multiprocessing
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.corpus.audioio import (
    load_recording,
    probe_duration,
)
from audio_training_tpu_torch.corpus.dataset import AudioDataset, Recording
from audio_training_tpu_torch.data.schema import SampleRecord, encode_sample
from audio_training_tpu_torch.data.tfrecord import TFRecordWriter

log = logging.getLogger(__name__)

# why ``embedding_model`` raises and ``cli/build --embedding-model`` exits 2
EMBEDDING_REFUSAL = (
    "loads a TensorFlow saved model (the JAX package's "
    "infer/embeddings.PerchModel), and the port does not depend on "
    "TensorFlow")

@dataclass
class SampleData:
    raw: np.ndarray
    raw_length: float
    spectogram: np.ndarray | None = None


def load_data(
    cfg: FeaturizerConfig,
    start_s: float,
    frames: np.ndarray,
    sr: int,
    end: float | None = None,
    store_spectrogram: bool = False,
    rng: np.random.Generator | None = None,
) -> SampleData:
    """Slice one 3 s window (audiodataset.load_data, audiodataset.py:1171-1331):
    short windows are re-centred with a random shift inside the recording,
    leftover shortfall is random-offset zero padded; raises when the result
    is constant (max==min assert, audiodataset.py:1311-1323)."""
    rng = rng or np.random.default_rng()
    segment_l = cfg.segment_length
    start = max(round(start_s * sr), 0)
    end_idx = round(end * sr) if end is not None else round(segment_l * sr) + start

    sr_data_l = int(sr * segment_l)
    missing = sr_data_l - (end_idx - start)
    if missing > 0:
        offset = int(rng.integers(0, missing)) if missing > 0 else 0
        start = start - offset
        if start <= 0:
            start = 0
            end_idx = min(start + sr_data_l, len(frames))
        else:
            end_offset = end_idx + missing - offset
            if end_offset > len(frames):
                end_offset = len(frames)
                start = max(end_offset - sr_data_l, 0)
            end_idx = end_offset
    s_data = frames[start : int(segment_l * sr + start)]

    if end_idx > len(frames) or start > len(frames):
        over = (end_idx - len(frames)) / sr
        if over >= 0.5:
            raise ValueError("Out of frame bounds")

    raw_length = len(s_data) / sr
    if len(s_data) < sr_data_l:
        extra = sr_data_l - len(s_data)
        offset = int(rng.integers(0, extra)) if extra > 0 else 0
        s_data = np.pad(s_data, (offset, extra - offset))
    assert len(s_data) == sr_data_l

    if s_data.max() == s_data.min():
        raise ValueError("Max is min (constant window)")

    spec = None
    if store_spectrogram:
        # reference stores |librosa.stft(normalized)| (audiodataset.py:1303)
        import torch

        from audio_training_tpu_torch.detect.signals import _host_stft_mag
        from audio_training_tpu_torch.ops.features import normalize_waveform

        normed = normalize_waveform(torch.from_numpy(
            np.asarray(s_data, np.float32)[None]))[0].numpy()
        spec = _host_stft_mag(normed, cfg.n_fft, cfg.hop_length)
    return SampleData(np.asarray(s_data, np.float32), raw_length, spec)


def process_recording(
    rec: Recording,
    cfg: FeaturizerConfig,
    store_spectrogram: bool = False,
    check_duration: bool = True,
    add_features: bool = False,
    add_buttered: bool = False,
) -> list[bytes]:
    """Decode one recording and serialize its samples
    (audiowriter.process_job + save_data, audiowriter.py:239-311,360-488).

    The JAX package's ``embedder`` argument (the reference's DO_EMBEDDING
    path, audiowriter.py:212,248-253,440-453) is left out: its embedders
    are TensorFlow saved models (see the module docstring).

    ``add_buttered`` stores a Butterworth band-passed variant of each
    sample whose track carries frequency bounds, feeding the pipeline's
    ``filter_freq``/``random_butter`` training option
    (tfdataset.py:1066-1078).  The reference's write side intended the
    same (``butter_bandpass_filter(s_data, min_freq, max_freq, sr)``,
    audiodataset.py:1301) but ships with it commented out, leaving its
    decode path dead; here the capability is functional and opt-in."""
    frames, sr = load_recording(rec.filename, target_sr=cfg.sr)
    if check_duration:
        probed = probe_duration(rec.filename)
        loaded = len(frames) / sr
        if probed is not None and abs(probed - loaded) > 1.5:
            raise ValueError(
                f"duration mismatch for {rec.filename}: probe {probed:.1f}s "
                f"vs decoded {loaded:.1f}s"
            )
    out = []
    for sample in rec.samples:
        try:
            data = load_data(cfg, sample.start, frames, sr,
                             end=sample.end,
                             store_spectrogram=store_spectrogram)
        except Exception as e:
            log.warning("skipping sample %s: %s", sample, e)
            continue
        record = SampleRecord(
            raw=data.raw,
            tags=list(sample.tags),
            text_tags=list(sample.text_tags),
            rec_id=str(sample.rec_id),
            track_ids=[str(t) for t in sample.track_ids],
            sr=sr,
            lat=(sample.location[0] if sample.location else 0.0) or 0.0,
            lng=(sample.location[1] if sample.location else 0.0) or 0.0,
            min_freq=-1 if sample.min_freq is None else sample.min_freq,
            max_freq=-1 if sample.max_freq is None else sample.max_freq,
            length=sample.length,
            raw_length=data.raw_length,
            start_s=sample.start,
            signal_percent=sample.signal_percent or 0,
            low_sample=int(bool(sample.low_sample)),
            spectogram=data.spectogram,
            mixed_label=sample.mixed_label,
        )
        max_f = sample.max_freq or 0
        min_f = sample.min_freq or 0
        if add_buttered and max_f > 0 and min_f < max_f:
            # butter_bandpass_sos additionally returns None (-> identity)
            # on malformed bounds, so a bad track can't raise here and take
            # the whole recording down with it
            from audio_training_tpu_torch.ops.features import (
                butter_bandpass_filter,
            )

            band = butter_bandpass_filter(data.raw, min_f, max_f, fs=sr)
            if (
                band is not data.raw
                and np.count_nonzero(band)
                and np.isfinite(band).all()
            ):
                record.buttered = band.astype(np.float32)
        if add_features:
            # hand-crafted short/mid features (audiowriter add_features,
            # audiowriter.py:370 + audiodataset.load_features)
            from audio_training_tpu_torch.corpus.features import load_features

            short_f, mid_f = load_features(data.raw, sr)
            record.short_features = short_f.astype(np.float32)
            record.mid_features = mid_f.astype(np.float32)
        out.append(record)
    return [encode_sample(r) for r in out]


def _worker(job_queue, out_dir: Path, worker_i: int, cfg: FeaturizerConfig,
            shards_per_worker: int, store_spectrogram: bool,
            add_features: bool = False,
            add_buttered: bool = False):
    """One writer process: round-robin over its own shard files
    (audiowriter.py:239-311)."""
    writers = [
        TFRecordWriter(out_dir / f"{worker_i:02d}-{s}.tfrecord")
        for s in range(shards_per_worker)
    ]
    i = 0
    while True:
        rec = job_queue.get()
        if rec is None:
            break
        try:
            for record in process_recording(
                rec, cfg, store_spectrogram=store_spectrogram,
                add_features=add_features, add_buttered=add_buttered,
            ):
                writers[i % shards_per_worker].write(record)
                i += 1
        except Exception:
            log.error("error processing %s", rec.filename, exc_info=True)
    for w in writers:
        w.close()


def create_tf_records(
    dataset: AudioDataset,
    out_dir: str | Path,
    labels=None,
    num_workers: int = 4,
    shards_per_worker: int = 4,
    cfg: FeaturizerConfig | None = None,
    store_spectrogram: bool = False,
    embedding_model: str | None = None,
    add_features: bool = False,
    add_buttered: bool = False,
) -> int:
    """Write a dataset split to GZIP TFRecord shards
    (audiowriter.create_tf_records, audiowriter.py:578-642).
    ``embedding_model`` (a Perch saved-model path in the JAX package)
    raises ``NotImplementedError``: see the module docstring.

    Returns the number of records written on the in-process path
    (``num_workers <= 1``) and the number of recordings queued on the
    multiprocess path, as the JAX package does."""
    if embedding_model:
        raise NotImplementedError(f"embedding_model {EMBEDDING_REFUSAL}")
    cfg = cfg or FeaturizerConfig()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    recs = list(dataset.recs.values())

    if num_workers <= 1:
        # in-process path (small datasets / tests)
        writer = TFRecordWriter(out_dir / "00-0.tfrecord")
        n = 0
        for rec in recs:
            try:
                for record in process_recording(
                    rec, cfg, store_spectrogram=store_spectrogram,
                    add_features=add_features, add_buttered=add_buttered,
                ):
                    writer.write(record)
                    n += 1
            except Exception:
                log.error("error processing %s", rec.filename, exc_info=True)
        writer.close()
        return n

    # spawn, not fork (the JAX package takes the default, fork on Linux):
    # the parent may hold a CUDA context and live threads (the loaders'
    # prefetch threads, torch's pools), and a forked child of a threaded
    # process can deadlock on a lock held at the fork (Python 3.12 warns).
    # Spawned workers import this module and re-import the main module as
    # ``__mp_main__``, so a script that builds keeps its body under
    # ``if __name__ == "__main__"``.
    ctx = multiprocessing.get_context("spawn")
    job_queue = ctx.Queue()
    workers = [
        ctx.Process(
            target=_worker,
            args=(job_queue, out_dir, w, cfg, shards_per_worker,
                  store_spectrogram, add_features, add_buttered),
        )
        for w in range(num_workers)
    ]
    for w in workers:
        w.start()
    for rec in recs:
        job_queue.put(rec)
    for _ in workers:
        job_queue.put(None)
    for w in workers:
        w.join()
    # the recordings, not the records: the reference's quirk, kept
    return len(recs)
