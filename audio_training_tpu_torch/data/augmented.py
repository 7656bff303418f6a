"""Offline mixup TFRecord writer (createaugmentedset.py parity): zip two
shuffled passes over a built dataset, eagerly mix waveforms with a uniform
weight in [0.2, 0.8], union the labels/track ids, and write new shards.

A copy of ``audio_training_tpu/data/augmented.py`` with the port's imports.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.data.schema import SampleRecord, decode_sample, encode_sample
from audio_training_tpu_torch.data.tfrecord import TFRecordWriter, read_tfrecords

log = logging.getLogger(__name__)


def mix_records(a, b, weight: float) -> SampleRecord:
    """Eager two-sample mixup (createaugmentedset.mix_up,
    createaugmentedset.py:443-522): weighted waveform sum, label/track-id
    union, mixed_label records the partner's tag."""
    raw = (a.raw * weight + b.raw * (1.0 - weight)).astype(np.float32)
    tags = sorted(set(a.tags) | set(b.tags))
    return SampleRecord(
        raw=raw,
        tags=tags,
        text_tags=sorted(set(a.text_tags) | set(b.text_tags)),
        rec_id=a.rec_id,
        track_ids=sorted(set(a.track_ids) | set(b.track_ids)),
        lat=a.lat,
        lng=a.lng,
        min_freq=min(a.min_freq, b.min_freq),
        max_freq=max(a.max_freq, b.max_freq),
        start_s=a.start_s,
        signal_percent=max(a.signal_percent, b.signal_percent),
        low_sample=a.low_sample,
        mixed_label=(b.tags[0] if b.tags else None),
    )


def create_augmented_set(
    shards: list[str | Path],
    out_dir: str | Path,
    records_per_shard: int = 1000,
    weight_range: tuple[float, float] = (0.2, 0.8),
    seed: int = 0,
) -> int:
    """Write an offline-mixed dataset (createaugmentedset.main/write,
    createaugmentedset.py:58-152)."""
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    samples = []
    for shard in shards:
        for rec in read_tfrecords(shard, skip_errors=True):
            try:
                samples.append(decode_sample(rec))
            except Exception:
                continue
    if len(samples) < 2:
        return 0
    order_a = rng.permutation(len(samples))
    order_b = rng.permutation(len(samples))

    n = 0
    writer = None
    for ia, ib in zip(order_a, order_b):
        if ia == ib:
            continue
        a, b = samples[ia], samples[ib]
        if a.raw.size != b.raw.size or a.raw.size == 0:
            continue
        w = float(rng.uniform(*weight_range))
        mixed = mix_records(a, b, w)
        if writer is None or n % records_per_shard == 0:
            if writer is not None:
                writer.close()
            writer = TFRecordWriter(
                out_dir / f"mixed-{n // records_per_shard:05d}.tfrecord"
            )
        writer.write(encode_sample(mixed))
        n += 1
    if writer is not None:
        writer.close()
    return n
