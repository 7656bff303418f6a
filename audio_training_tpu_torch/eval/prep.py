"""Multiprocess evaluation preprocessing (a copy of
``audio_training_tpu/eval/prep.py``).

The reference fans the per-file decode -> track-detect -> window prep of
directory evaluation over an 8-process Pool (audiomodel.py:1856-1857,
evaluate.py:81) while the model predicts in the parent.  This module is the
equivalent host-side fan-out: workers produce ready window batches, the
parent streams them through the Predictor on the card.

Workers use a spawn context (the parent has live torch and CUDA threads;
forking a multithreaded process is a latent deadlock) and never touch the
card: they decode, detect and window on the host.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
from typing import Iterable, Iterator

import numpy as np

log = logging.getLogger(__name__)

DEFAULT_EVAL_WORKERS = 8  # the reference's Pool size (audiomodel.py:1856)


def preprocess_eval_file(args: tuple) -> tuple:
    """One file's eval prep: load -> get_end -> signal detection -> track
    merge -> sliding windows (evaluate.preprocess_audio, evaluate.py:260-299).

    ``args = (key, path, sr, segment_length, stride, fmin, fmax)``; returns
    ``(key, windows, track_index, num_tracks, error_repr)``.  Top-level so
    a spawn Pool can pickle it.
    """
    key, path, sr, segment_length, stride, fmin, fmax = args
    try:
        from audio_training_tpu_torch.corpus.audioio import load_recording
        from audio_training_tpu_torch.detect.signals import (
            get_end,
            get_tracks_from_signals,
            signal_noise,
        )
        from audio_training_tpu_torch.infer.windows import extract_track_windows

        frames, sr_ = load_recording(path, target_sr=sr)
        end = get_end(frames, sr_)
        signals, _ = signal_noise(frames, sr_)
        tracks = get_tracks_from_signals(signals, end)
        batch = extract_track_windows(
            frames, sr_, tracks,
            segment_length=segment_length, stride=stride,
            fmin=fmin, fmax=fmax,
        )
        return key, batch.windows, batch.track_index, len(tracks), None
    except Exception as exc:  # worker crash must not kill the pool
        return key, None, None, 0, repr(exc)


def preprocess_span_file(args: tuple) -> tuple:
    """One file's annotated-span prep: load -> window the given [start, end)
    span (predict.predict_on_folder's per-file work, predict.py:511-596) —
    no signal detection, the span IS the track.

    ``args = (key, path, sr, start, end, segment_length, stride, fmin,
    fmax)``; returns ``(key, windows, error_repr)``.
    """
    key, path, sr, start, end, segment_length, stride, fmin, fmax = args
    try:
        from audio_training_tpu_torch.corpus.audioio import load_recording
        from audio_training_tpu_torch.detect.signals import Signal
        from audio_training_tpu_torch.infer.windows import extract_track_windows

        frames, sr_ = load_recording(path, target_sr=sr)
        rec_end = len(frames) / sr_
        track = Signal(start, min(rec_end, end), 0, 15000, 0)
        batch = extract_track_windows(
            frames, sr_, [track],
            segment_length=segment_length, stride=stride,
            fmin=fmin, fmax=fmax,
        )
        return key, batch.windows, None
    except Exception as exc:
        return key, None, repr(exc)


def preprocessed_span_stream(
    items: Iterable[tuple[object, str, float, float]],
    cfg,
    workers: int = DEFAULT_EVAL_WORKERS,
) -> Iterator[tuple]:
    """Yield ``(key, windows, error)`` for ``(key, path, start, end)`` items,
    windowing ``workers`` files concurrently (inline when ``workers <= 1``)."""
    args = [
        (key, str(path), cfg.sr, start, end, cfg.segment_length,
         cfg.segment_stride, cfg.fmin, cfg.fmax)
        for key, path, start, end in items
    ]
    if workers <= 1 or len(args) <= 1:
        for a in args:
            yield preprocess_span_file(a)
        return
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(workers, len(args))) as pool:
        yield from pool.imap(preprocess_span_file, args, chunksize=1)


def preprocessed_eval_stream(
    items: Iterable[tuple[object, str]],
    cfg,
    workers: int = DEFAULT_EVAL_WORKERS,
) -> Iterator[tuple]:
    """Yield ``(key, windows, track_index, num_tracks, error)`` for each
    ``(key, path)`` item, preprocessing ``workers`` files concurrently.

    Results stream in submission order (``imap``) so evaluation output is
    deterministic.  ``workers <= 1`` runs inline — no processes — which
    keeps tiny evaluations and tests cheap.
    """
    args = [
        (key, str(path), cfg.sr, cfg.segment_length, cfg.segment_stride,
         cfg.fmin, cfg.fmax)
        for key, path in items
    ]
    if workers <= 1 or len(args) <= 1:
        for a in args:
            yield preprocess_eval_file(a)
        return
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(workers, len(args))) as pool:
        # chunksize 1: files vary wildly in length; bigger chunks serialize
        # a long file behind short ones
        yield from pool.imap(preprocess_eval_file, args, chunksize=1)
