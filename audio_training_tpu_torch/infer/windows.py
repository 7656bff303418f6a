"""Sliding-window extraction for long-recording inference (a copy of
``audio_training_tpu/infer/windows.py``).

Host-side equivalent of ``predict_utils.load_samples``
(predict_utils.py:9-150): per detected track, 3 s windows at 1 s stride;
short tracks are centered in a 3 s context (window growing backward/forward
within the recording); leftover shortfall is random-offset zero-padded;
optional per-track butterworth band-pass.

The windows stay raw waveforms: all windows of all tracks are packed into
one (N, sample_size) array plus a track-id vector, and the Predictor
featurizes and classifies them in batches on the card (ragged tracks become
a flat batch plus segment ids; aggregation is a segment reduction).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from audio_training_tpu_torch.ops.features import butter_bandpass_filter


@dataclass
class WindowBatch:
    windows: np.ndarray  # (N, sample_size) float32 raw waveforms
    track_index: np.ndarray  # (N,) int32 — which track each window belongs to
    offsets: np.ndarray  # (N,) float32 — window start time within recording
    skipped_tracks: list[int] = field(default_factory=list)


def extract_track_windows(
    frames: np.ndarray,
    sr: int,
    tracks: list,
    segment_length: float = 3.0,
    stride: float = 1.0,
    fmin: float = 100.0,
    fmax: float = 11000.0,
    filter_freqs: bool = False,
    filter_below: float | None = None,
    rng: np.random.Generator | None = None,
) -> WindowBatch:
    """Slice every track into fixed-size windows (predict_utils.py:59-149)."""
    rng = rng or np.random.default_rng()
    sample_size = int(sr * segment_length)
    windows: list[np.ndarray] = []
    track_idx: list[int] = []
    offsets: list[float] = []
    skipped: list[int] = []

    for ti, t in enumerate(tracks):
        f_lo = getattr(t, "freq_start", None)
        f_hi = getattr(t, "freq_end", None)
        if f_lo is not None and f_hi is not None and (f_lo > fmax or f_hi < fmin):
            skipped.append(ti)  # entirely out of the model's band
            continue

        sr_start = int(t.start * sr)
        sr_end = int(t.end * sr)
        # grow a short track to a full window, centered, clamped to the
        # recording (predict_utils.py:80-98)
        missing = sample_size - (sr_end - sr_start)
        if missing > 0:
            offset = missing // 2
            sr_start = sr_start - offset
            if sr_start <= 0:
                sr_start = 0
                sr_end = min(sample_size, len(frames))
            else:
                end_offset = sr_end + missing - offset
                if end_offset > len(frames):
                    end_offset = len(frames)
                    sr_start = max(end_offset - sample_size, 0)
                sr_end = end_offset
        track_frames = np.asarray(frames[sr_start:sr_end], np.float32)

        if filter_freqs or (
            filter_below is not None and f_hi is not None and f_hi < filter_below
        ):
            track_frames = butter_bandpass_filter(
                track_frames, f_lo or 0, f_hi or 0, sr
            )

        start = 0.0
        w_start = 0
        w_end = min(sr_end - sr_start, sample_size)
        while True:
            data = track_frames[w_start:w_end]
            if len(data) != sample_size:
                extra = sample_size - len(data)
                off = int(rng.integers(0, extra)) if extra > 0 else 0
                data = np.pad(data, (off, extra - off))
            windows.append(data)
            track_idx.append(ti)
            offsets.append(t.start + start)
            start += stride
            w_start = int(start * sr)
            w_end = min(int((start + segment_length) * sr),
                        w_start + sample_size)
            if start + segment_length > t.length:
                break

    if windows:
        w = np.stack(windows)
    else:
        w = np.zeros((0, sample_size), np.float32)
    return WindowBatch(
        windows=w,
        track_index=np.asarray(track_idx, np.int32),
        offsets=np.asarray(offsets, np.float32),
        skipped_tracks=skipped,
    )


def bucket_pad(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n, or a multiple of the largest bucket: ragged
    window counts pad to a few batch shapes."""
    for b in buckets:
        if n <= b:
            return b
    # round up to a multiple of the largest bucket
    big = buckets[-1]
    return ((n + big - 1) // big) * big
