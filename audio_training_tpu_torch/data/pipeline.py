"""Host-side input pipeline: sharded record streaming -> device batches
(port of ``audio_training_tpu/data/pipeline.py:44-530``).

The replacement for the reference's ``tf.data`` graph
(tfdataset.get_a_dataset/load_dataset, tfdataset.py:193-304,517-917).  The
host only decodes bytes and assembles fixed-shape float32 batches; everything
from the waveform onward (normalize, mixup, STFT, mel) runs on the device
(see :mod:`audio_training_tpu_torch.data.preprocess`).  The stream order
comes from Python's ``random.Random(seed)`` and numpy alone, so for one seed
the port yields the JAX package's samples, labels, mixup partners and GPS
bit for bit.

Semantics replicated from the reference:
* shard-file shuffle unless deterministic (tfdataset.py:193-197)
* a 4096-sample shuffle buffer (tfdataset.py:836-839)
* uniform interleaving of multiple source datasets (sample_from_datasets,
  tfdataset.py:843-848)
* corrupt-record skipping (ignore_errors, tfdataset.py:226)
* NaN/Inf sample filtering (filter_nan_samples, tfdataset.py:297-312)
* label one-hot with remap + generic-bird extra hit (tfdataset.py:546-578)
* mixup via a second, independently-shuffled stream instance
  (tfdataset.py:468-480)
* double-buffered host->device prefetch (prefetch AUTOTUNE, tfdataset.py:505):
  on a CUDA device the batch is pinned and copied on a side stream
  (:class:`DeviceCopier`)
"""

from __future__ import annotations

import os
import json
import logging
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from audio_training_tpu_torch.data.schema import decode_sample
from audio_training_tpu_torch.data.tfrecord import read_tfrecords
from audio_training_tpu_torch.taxonomy.labels import LabelSpace

log = logging.getLogger(__name__)

SHUFFLE_BUFFER = 4096


def find_shards(data_dir: str | Path, split: str | None = None) -> list[Path]:
    d = Path(data_dir)
    if split is not None:
        d = d / split
    return sorted(d.glob("*.tfrecord"))


def load_meta(data_dir: str | Path) -> dict:
    """training-meta.json written by the dataset build (build.py:795-814)."""
    return json.loads((Path(data_dir) / "training-meta.json").read_text())


@dataclass
class SampleBatch:
    raw: np.ndarray  # (B, samples) float32
    labels: np.ndarray  # (B, num_labels) float32
    latlng: Optional[np.ndarray] = None  # (B, 2) float32 when requested


class RecordStream:
    """Infinite (or single-epoch) stream of decoded (raw, one_hot) samples
    from one dataset directory."""

    def __init__(
        self,
        shards: list[Path],
        label_space: LabelSpace,
        samples_per_clip: int,
        seed: int = 0,
        deterministic: bool = False,
        shuffle: bool = True,
        loop: bool = True,
        keep_unlabeled: bool = False,
        cache: bool = False,
        verify_crc: bool = False,
        with_latlng: bool = False,
        with_features: bool = False,
        exclude_low_samples: bool = False,
        drop_bird_only: bool = False,
        filter_freq: bool = False,
        random_butter: float = 0.0,
    ):
        if not shards:
            raise ValueError("no shard files found")
        self.shards = list(shards)
        self.space = label_space
        self.samples_per_clip = samples_per_clip
        self.rng = random.Random(seed)
        self.deterministic = deterministic
        self.shuffle = shuffle and not deterministic
        self.loop = loop
        self.keep_unlabeled = keep_unlabeled
        # .cache() parity (tfdataset.py:830-833): decoded samples are kept in
        # RAM after the first pass, so later epochs never touch gzip again.
        self.cache = cache
        self.verify_crc = verify_crc
        # when set, items are (raw, one_hot, [lat, lng]) — the GPS feeds the
        # NZ-box possible_labels loss weighting (tfdataset.py:1188-1212)
        self.with_latlng = with_latlng
        # when set, items are (raw, one_hot, short_f, mid_f) for the merge
        # model's joint training (tfdataset.py:1103-1119); records without
        # both feature tensors are skipped, matching the reference's
        # count_nonzero filter (tfdataset.py:283-289)
        self.with_features = with_features
        # --no-low-samples: drop samples produced by oversampling of
        # low-count labels (tfdataset.py:728-733; the y[6] the reference
        # filters on is the decoded low_sample flag, tfdataset.py:1051)
        self.exclude_low_samples = exclude_low_samples
        # default-on bird-tag filter (inverted as use_bird_tags in the
        # reference CLI): drop samples whose resolved label set is EXACTLY
        # the generic "bird" hit — tagged bird with no specific species
        # (tfdataset.py:735-755, others_filter)
        self.drop_bird_only = drop_bird_only
        self._bird_only = None
        if drop_bird_only and "bird" in label_space.labels:
            m = np.zeros(label_space.num_labels, np.float32)
            m[label_space.index_of("bird")] = 1.0
            self._bird_only = m
        # filter_freq/random_butter: train on the band-passed variant of a
        # sample when the record carries one — always when random_butter is
        # 0, else with that probability per visit (tfdataset.py:1066-1078;
        # the reference stores a band-passed SPECTROGRAM, this pipeline a
        # band-passed waveform, same decode-time choice)
        self.filter_freq = filter_freq
        self.random_butter = float(random_butter)
        self._cached: list[tuple[np.ndarray, np.ndarray]] | None = None
        self._tag_index = {l: i for i, l in enumerate(label_space.source_labels)}

    def _one_hot(self, tags: list[str]) -> Optional[np.ndarray]:
        ids = [self._tag_index[t] for t in tags if t in self._tag_index]
        y = self.space.one_hot(ids)
        if y.sum() == 0 and not self.keep_unlabeled:
            return None
        return y

    def _decode_one(self, rec) -> Optional[tuple[np.ndarray, np.ndarray]]:
        try:
            s = decode_sample(rec, want_features=self.with_features,
                              want_buttered=self.filter_freq)
        except Exception:
            return None  # ignore_errors parity (tfdataset.py:226)
        if self.exclude_low_samples and s.low_sample:
            return None  # tfdataset.py:728-733
        raw = s.raw
        if (
            self.filter_freq
            and s.buttered is not None
            and np.count_nonzero(s.buttered)
            and (
                self.random_butter <= 0.0
                or self.rng.random() <= self.random_butter
            )
        ):
            # per-visit choice like the reference's tf.cond on a fresh
            # uniform (tfdataset.py:1068-1078); train streams re-decode
            # every epoch so the coin is re-flipped per pass
            raw = s.buttered
        if raw.size != self.samples_per_clip:
            if raw.size == 0:
                return None
            if raw.size < self.samples_per_clip:
                raw = np.pad(raw, (0, self.samples_per_clip - raw.size))
            else:
                raw = raw[: self.samples_per_clip]
        if not np.isfinite(raw).all():
            return None  # NaN/Inf filter (tfdataset.py:297-312)
        y = self._one_hot(s.tags)
        if y is None:
            return None
        if self._bird_only is not None and np.array_equal(y, self._bird_only):
            return None  # generic-bird-only sample (tfdataset.py:751-755)
        if self.with_features:
            short_f, mid_f = s.short_features, s.mid_features
            if (
                short_f is None or mid_f is None
                or not np.count_nonzero(short_f)
                or not np.count_nonzero(mid_f)
                or not np.isfinite(short_f).all()
                or not np.isfinite(mid_f).all()
            ):
                return None
            return raw, y, short_f, mid_f
        if self.with_latlng:
            return raw, y, np.array([s.lat, s.lng], np.float32)
        return raw, y

    def _iter_one_epoch(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One pass over the shard set (decoding from disk, or from the RAM
        cache once it is filled)."""
        if self.cache and self._cached is not None:
            order = (
                self.rng.sample(self._cached, len(self._cached))
                if self.shuffle
                else self._cached
            )
            yield from order
            return
        filling = [] if self.cache else None
        order = list(self.shards)
        if self.shuffle:
            self.rng.shuffle(order)
        for shard in order:
            for rec in read_tfrecords(
                shard, verify_crc=self.verify_crc, skip_errors=True
            ):
                item = self._decode_one(rec)
                if item is None:
                    continue
                if filling is not None:
                    filling.append(item)
                yield item
        if filling is not None:
            self._cached = filling

    def _iter_decoded(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            n = 0
            for item in self._iter_one_epoch():
                n += 1
                yield item
            if not self.loop or n == 0:  # empty set: don't spin forever
                return

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if not self.shuffle:
            yield from self._iter_decoded()
            return
        # shuffle buffer (tf.data .shuffle(4096) parity).  The fill phase is
        # bounded by ONE epoch: a looping stream smaller than the buffer must
        # not be decoded over and over just to fill it (that made tiny
        # datasets decompress their shards ~50x before the first sample).
        buf: list[tuple[np.ndarray, np.ndarray]] = []
        first_pass = self._iter_one_epoch()
        for item in first_pass:
            buf.append(item)
            if len(buf) >= SHUFFLE_BUFFER:
                break

        def rest() -> Iterator:
            yield from first_pass
            while self.loop and buf:  # empty set: don't spin forever
                yield from self._iter_one_epoch()

        for item in rest():
            idx = self.rng.randrange(len(buf))
            yield buf[idx]
            buf[idx] = item
        self.rng.shuffle(buf)
        yield from buf

    def count(self) -> int:
        """Number of usable samples (one pass, decode-light)."""
        n = 0
        for shard in self.shards:
            for rec in read_tfrecords(shard, skip_errors=True):
                try:
                    s = decode_sample(rec, want_raw=False)
                except Exception:
                    continue
                if self._one_hot(s.tags) is not None:
                    n += 1
        return n


def interleave(
    streams: list[Iterator], weights: list[float] | None, seed: int = 0
) -> Iterator:
    """sample_from_datasets equivalent: draw each element from a randomly
    chosen stream (uniform unless weights given); a finished stream drops
    out (stop_on_empty_dataset=False, tfdataset.py:843-848)."""
    rng = random.Random(seed)
    streams = list(streams)
    weights = list(weights) if weights else [1.0] * len(streams)
    while streams:
        i = rng.choices(range(len(streams)), weights=weights)[0]
        try:
            yield next(streams[i])
        except StopIteration:
            del streams[i]
            del weights[i]




class DeviceCopier:
    """Host batch arrays -> tensors on ``device``: the ``jax.device_put`` of
    the JAX loaders (pipeline.py:344-349, parallel_loader.py:102-107).

    On a CUDA device :meth:`put`, called from a producer thread, pins each
    array and copies it with ``non_blocking=True`` on a side stream, then
    records an event there; :meth:`ready`, called by the consumer, makes
    the consumer's current stream wait on that event and marks the tensors
    as used by it (``record_stream``), so that a step never reads a
    half-copied batch and the allocator does not reuse a batch's memory
    while the step still reads it.  The pinned staging buffers stay alive
    until their copy ends (PyTorch's pinned-memory allocator records the
    copy).  On the CPU the tensors share the arrays' memory."""

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def put(self, arrays) -> tuple:
        tensors = [torch.from_numpy(a) for a in arrays]
        if self.stream is None:
            return tuple(t.to(self.device) for t in tensors), None
        with torch.cuda.stream(self.stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in tensors)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, item) -> tuple:
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors


class BatchLoader:
    """Assemble fixed-shape batches and prefetch them to ``device``.

    When ``mix_stream`` is given, each step also yields a partner batch from
    the second, independently shuffled pipeline instance — the host half of
    the reference's mixup zip (tfdataset.py:468-480).  Items are tuples of
    tensors on ``device`` (see :class:`DeviceCopier`).
    """

    def __init__(
        self,
        stream: Iterator[tuple[np.ndarray, np.ndarray]],
        batch_size: int,
        num_labels: int,
        samples_per_clip: int,
        mix_stream: Iterator[tuple[np.ndarray, np.ndarray]] | None = None,
        prefetch: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.stream = stream
        self.mix_stream = mix_stream
        self.batch_size = batch_size
        self.num_labels = num_labels
        self.samples_per_clip = samples_per_clip
        self.prefetch = prefetch
        self.device = device

    def _next_batch(self, stream) -> Optional[SampleBatch]:
        raw = np.empty((self.batch_size, self.samples_per_clip), np.float32)
        y = np.empty((self.batch_size, self.num_labels), np.float32)
        latlng = None
        n = 0
        for i in range(self.batch_size):
            try:
                item = next(stream)
            except StopIteration:
                break
            raw[i] = item[0]
            y[i] = item[1]
            n += 1
            if len(item) > 2:
                if latlng is None:
                    latlng = np.zeros((self.batch_size, 2), np.float32)
                latlng[i] = item[2]
        if n == self.batch_size:
            return SampleBatch(raw, y, latlng)
        # Partial tail batch: Keras evaluates it (the reference batches
        # without drop_remainder); emit it trimmed for single-stream eval
        # passes.  Mixup training keeps fixed shapes (the partner zip drops
        # remainders in the reference too).
        if n == 0 or self.mix_stream is not None:
            return None
        return SampleBatch(
            raw[:n], y[:n], latlng[:n] if latlng is not None else None
        )

    def __iter__(self):
        import queue as queue_mod
        import threading

        copier = DeviceCopier(self.device)

        def produce():
            # batch tuple convention: (raw, y[, raw2, y2][, latlng]) — the
            # mixup partner's GPS is dropped (the reference never mixes
            # possible_labels either, tfdataset.py:954)
            b = self._next_batch(self.stream)
            if b is None:
                return None
            out = [b.raw, b.labels]
            if self.mix_stream is not None:
                b2 = self._next_batch(self.mix_stream)
                if b2 is None:
                    return None
                out += [b2.raw, b2.labels]
            if b.latlng is not None:
                out.append(b.latlng)
            return copier.put(out)

        # host decode (gzip + proto) and the host->device copy run in a
        # producer thread so they overlap device compute (the tf.data
        # prefetch(AUTOTUNE) equivalent, tfdataset.py:505)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        sentinel = object()

        class _Raised:
            def __init__(self, exc):
                self.exc = exc

        def producer():
            try:
                while not stop.is_set():
                    try:
                        item = produce()
                    except Exception as e:  # surfaced to the consumer
                        item = _Raised(e)
                    done = item is None or isinstance(item, _Raised)
                    while not stop.is_set():
                        try:
                            q.put(sentinel if item is None else item,
                                  timeout=0.5)
                            break
                        except queue_mod.Full:
                            continue
                    if done:
                        return
            finally:
                stop.set()

        t = threading.Thread(target=producer, daemon=True,
                             name="batch-loader-prefetch")
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.5)
                except queue_mod.Empty:
                    if stop.is_set() and q.empty():
                        return
                    continue
                if item is sentinel:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                yield copier.ready(item)
        finally:
            stop.set()


def build_training_stream(
    data_dirs: list[str | Path],
    split: str,
    label_space: LabelSpace,
    samples_per_clip: int,
    batch_size: int,
    seed: int = 0,
    augment: bool = False,
    deterministic: bool = False,
    weights: list[float] | None = None,
    device: str | torch.device = "cuda",
    cache: bool | None = None,
    with_latlng: bool = False,
    shard_groups: list[list[Path]] | None = None,
    workers: int | None = None,
    exclude_low_samples: bool = False,
    drop_bird_only: bool = False,
    filter_freq: bool = False,
    random_butter: float = 0.0,
):
    """End-to-end loader for one split over one or more dataset dirs
    (main/second/human dataset merging, audiomodel.py:1582-1644).

    ``shard_groups`` overrides directory discovery with explicit shard-file
    lists (one group per source stream) — the k-fold CV path partitions
    files directly, like the reference's KFold over filenames
    (audiomodel.py:227-233).

    ``workers`` > 1 selects multiprocess shard decoding for the train split
    (``data.parallel_loader.ParallelLoader``, spawned workers — the
    read-side mirror of the reference's 8-proc writer pool).  It is opt-in
    (flag, TrainConfig, or the AUDIO_TPU_LOADER_WORKERS environment
    variable), as in the JAX package.  Paths the parallel loader doesn't
    cover (deterministic streams, eval caching, per-sample lat/lng,
    weighted multi-stream interleave, the decode-time filters) use the
    threaded ``BatchLoader``.  Batches land on ``device``.
    """

    # cache rule parity (tfdataset.py:830-833): non-train splits always cache;
    # train caching is opt-in (the full corpus may not fit in RAM).
    cache = cache if cache is not None else (split != "train")

    groups = (
        shard_groups
        if shard_groups is not None
        else [find_shards(d, split) for d in data_dirs]
    )

    if workers is None:
        env = os.environ.get("AUDIO_TPU_LOADER_WORKERS")
        workers = int(env) if env else 0
    parallel_ok = (
        workers > 1
        and augment          # train split: looped, uncached, unweighted
        and not deterministic  # workers race on the shared queue
        and not with_latlng  # geo loss needs the per-sample GPS path
        and not cache
        and weights is None
        and len(groups) == 1
        # decode-time sample filters/variants use the threaded path
        and not (exclude_low_samples or drop_bird_only or filter_freq)
    )
    if parallel_ok:
        from audio_training_tpu_torch.data.parallel_loader import ParallelLoader

        return ParallelLoader(
            list(groups[0]), label_space, samples_per_clip, batch_size,
            num_workers=workers, seed=seed, loop=True, mix=True,
            device=device,
        )

    def make(seed_offset: int) -> Iterator:
        streams = []
        for i, shards in enumerate(groups):
            streams.append(
                iter(
                    RecordStream(
                        shards,
                        label_space,
                        samples_per_clip,
                        seed=seed + seed_offset + i * 97,
                        deterministic=deterministic,
                        loop=augment,  # training streams loop; eval is 1 pass
                        cache=cache,
                        with_latlng=with_latlng,
                        exclude_low_samples=exclude_low_samples,
                        drop_bird_only=drop_bird_only,
                        filter_freq=filter_freq,
                        random_butter=random_butter,
                    )
                )
            )
        if len(streams) == 1:
            return streams[0]
        return interleave(streams, weights, seed=seed + seed_offset)

    mix = make(7919) if augment else None
    return BatchLoader(
        make(0),
        batch_size=batch_size,
        num_labels=label_space.num_labels,
        samples_per_clip=samples_per_clip,
        mix_stream=mix,
        device=device,
    )
