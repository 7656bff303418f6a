"""Vector-input streams (port of ``audio_training_tpu/data/embeddings.py``):
records carrying 1280-d Perch-style embeddings instead of waveforms
(tfdatasetembeddings.py parity), with optional z-normalization from a stats
file and per-label resampling, and the hand-crafted short / mid feature
tensors of the ``cnn-features`` / ``merge`` / ``rf-features`` runs.  Host
code on numpy: the streams read vectors already stored in the records, so
nothing here loads a model."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from audio_training_tpu_torch.data.schema import (
    MID_FEATURES_SHAPE,
    SHORT_FEATURES_SHAPE,
    decode_sample,
)
from audio_training_tpu_torch.data.tfrecord import read_tfrecords
from audio_training_tpu_torch.taxonomy.labels import LabelSpace

EMBEDDING_DIM = 1280  # Perch (tfdatasetembeddings.py:70)


def load_znorm(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """mean/std rows from zvalues.txt (tfdatasetembeddings.py:71-77)."""
    vals = np.loadtxt(path)
    return vals[0], vals[1]


class EmbeddingStream:
    """Decoded (embedding, one_hot) stream (tfdatasetembeddings.get_dataset /
    read_tfrecord, tfdatasetembeddings.py:239,453).  Shard order and
    within-shard item order reshuffle every pass (the reference pipeline
    shuffles; label-grouped shards would otherwise yield near-single-class
    batches)."""

    def __init__(
        self,
        shards: list[Path],
        label_space: LabelSpace,
        znorm: tuple[np.ndarray, np.ndarray] | None = None,
        loop: bool = False,
        seed: int = 0,
        shuffle: bool = True,
    ):
        self.shards = list(shards)
        self.space = label_space
        self.znorm = znorm
        self.loop = loop
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self._tag_index = {l: i for i, l in
                           enumerate(label_space.source_labels)}

    def _shard_items(self, shard):
        items = list(read_tfrecords(shard, skip_errors=True))
        if self.shuffle:
            self.rng.shuffle(items)
        return items

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            n_yielded = 0
            order = list(self.shards)
            if self.shuffle:
                self.rng.shuffle(order)
            for shard in order:
                for rec in self._shard_items(shard):
                    try:
                        s = decode_sample(rec, want_raw=False,
                                          want_embeddings=True)
                    except Exception:
                        continue
                    if s.embeddings is None:
                        continue
                    emb = np.asarray(s.embeddings, np.float32).reshape(-1)
                    if emb.size != EMBEDDING_DIM:
                        # windows x dim embeddings average over windows
                        if emb.size % EMBEDDING_DIM == 0:
                            emb = emb.reshape(-1, EMBEDDING_DIM).mean(0)
                        else:
                            continue
                    if self.znorm is not None:
                        mean, std = self.znorm
                        emb = (emb - mean) / np.where(std > 0, std, 1.0)
                    ids = [self._tag_index[t] for t in s.tags
                           if t in self._tag_index]
                    y = self.space.one_hot(ids)
                    if y.sum() == 0:
                        continue
                    n_yielded += 1
                    yield emb, y
            if not self.loop or n_yielded == 0:
                return  # empty pass: never busy-loop


def resample_per_label(
    items: list[tuple[np.ndarray, np.ndarray]],
    target: int | None = None,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Even per-label distribution by repetition/subsampling
    (tfdatasetembeddings.resample, tfdatasetembeddings.py:433)."""
    rng = np.random.default_rng(seed)
    by_label: dict[int, list] = {}
    for emb, y in items:
        for li in np.flatnonzero(y):
            by_label.setdefault(int(li), []).append((emb, y))
    if not by_label:
        return []
    if target is None:
        target = int(np.median([len(v) for v in by_label.values()]))
    out = []
    for li, pool in by_label.items():
        idx = rng.choice(len(pool), target, replace=len(pool) < target)
        out.extend(pool[i] for i in idx)
    rng.shuffle(out)
    return out


class FeatureStream:
    """Decoded (short_f, mid_f, one_hot) stream for the ``cnn-features`` /
    ``merge`` models (tfdataset.py:1041-1111 feature parsing; features
    written by ``corpus.writer`` with ``add_features=True``)."""

    def __init__(
        self,
        shards: list[Path],
        label_space: LabelSpace,
        loop: bool = False,
        seed: int = 0,
        shuffle: bool = True,
        exclude_low_samples: bool = False,
        drop_bird_only: bool = False,
    ):
        self.shards = list(shards)
        self.space = label_space
        self.loop = loop
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        # cnn-features/merge flow through the reference's MAIN tfdataset
        # pipeline (only_features), so its decode-time sample filters apply
        # here too (tfdataset.py:728-755); the Perch EmbeddingStream
        # mirrors tfdatasetembeddings.py, which has no such filters
        self.exclude_low_samples = exclude_low_samples
        self._bird_only = None
        if drop_bird_only and "bird" in label_space.labels:
            m = np.zeros(label_space.num_labels, np.float32)
            m[label_space.index_of("bird")] = 1.0
            self._bird_only = m
        self._tag_index = {l: i for i, l in
                           enumerate(label_space.source_labels)}

    def _shard_items(self, shard):
        items = list(read_tfrecords(shard, skip_errors=True))
        if self.shuffle:
            self.rng.shuffle(items)
        return items

    def __iter__(self):
        while True:
            n_yielded = 0
            order = list(self.shards)
            if self.shuffle:
                self.rng.shuffle(order)
            for shard in order:
                for rec in self._shard_items(shard):
                    try:
                        s = decode_sample(rec, want_raw=False,
                                          want_features=True)
                    except Exception:
                        continue
                    if self.exclude_low_samples and s.low_sample:
                        continue
                    if s.short_features is None or s.mid_features is None:
                        continue
                    try:
                        short = np.asarray(
                            s.short_features, np.float32
                        ).reshape(SHORT_FEATURES_SHAPE)
                        mid = np.asarray(
                            s.mid_features, np.float32
                        ).reshape(MID_FEATURES_SHAPE)
                    except ValueError:
                        continue
                    ids = [self._tag_index[t] for t in s.tags
                           if t in self._tag_index]
                    y = self.space.one_hot(ids)
                    if y.sum() == 0:
                        continue
                    if self._bird_only is not None and np.array_equal(
                            y, self._bird_only):
                        continue  # tfdataset.py:751-755
                    n_yielded += 1
                    yield short, mid, y
            if not self.loop or n_yielded == 0:
                return  # empty pass: never busy-loop
