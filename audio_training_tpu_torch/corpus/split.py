"""Train/val/test splitting and balancing (behavioral port of build.py; a
copy of ``audio_training_tpu/corpus/split.py`` with the port's imports).

The split is per-label and bin-aware: bins are recording ids, so one
recording never spans datasets (build.py:51-189); validation gets 15 %,
test 5 % (build.py:47-48).  Balancing uses the unused / small-stride /
repeat sample pools produced at sampling time (build.py:472-676), and a
leak assertion runs before writing (build.py:817-837).
"""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.config import config_to_dict
from audio_training_tpu_torch.corpus.dataset import (
    RELABEL,
    AudioDataset,
    AudioSample,
    Recording,
)

log = logging.getLogger(__name__)

MAX_TEST_BINS = None
MAX_TEST_SAMPLES = None
MIN_SAMPLES = 1
MIN_BINS = 1
LOW_SAMPLES_LABELS = ["bittern"]
VAL_PERCENT = 0.15
TEST_PERCENT = 0.05


def _add_sample(ds: AudioDataset, rec: Recording, sample: AudioSample) -> None:
    if rec.id not in ds.recs:
        clone = Recording(rec.metadata, rec.filename, None,
                          load_samples=False)
        clone.unused_samples = rec.unused_samples
        clone.small_strides = rec.small_strides
        ds.recs[rec.id] = clone
    ds.recs[rec.id].samples.append(sample)
    ds.samples.append(sample)
    ds.labels.update(sample.tags)


def _remove_sample(ds: AudioDataset, sample: AudioSample) -> None:
    try:
        ds.samples.remove(sample)
    except ValueError:
        pass
    rec = ds.recs.get(sample.rec_id)
    if rec is not None and sample in rec.samples:
        rec.samples.remove(sample)


def split_label(
    dataset: AudioDataset,
    datasets: tuple[AudioDataset, AudioDataset, AudioDataset],
    label: str,
    existing_test_count: int = 0,
    no_test: bool = False,
    rng: random.Random | None = None,
) -> None:
    """Move one label's bins into validation, test, then train
    (build.split_label, build.py:51-189)."""
    rng = rng or random
    samples_by_bin: dict[str, list[AudioSample]] = {}
    sample_bins: set[str] = set()
    tracks: set = set()
    num_samples = 0
    rec_by_id = dataset.recs
    for s in dataset.samples:
        if s.rec_id not in rec_by_id:
            continue
        rec = rec_by_id[s.rec_id]
        if label not in rec.human_tags:
            continue
        if label in s.tags:
            sample_bins.add(s.bin_id)
            tracks |= set(s.track_ids)
            num_samples += 1
        samples_by_bin.setdefault(s.bin_id, []).append(s)
    bins_list = list(sample_bins)
    if not bins_list:
        return
    rng.shuffle(bins_list)
    train_c, validate_c, test_c = datasets

    min_samples = MIN_SAMPLES
    min_bins = MIN_BINS
    total_bins = len(bins_list)
    if label in LOW_SAMPLES_LABELS or total_bins < 20:
        min_bins = 1
        min_samples = 1
    if label in LOW_SAMPLES_LABELS:
        min_samples = 10

    num_val_samples = max(num_samples * VAL_PERCENT, min_samples)
    num_test_samples = max(num_samples * TEST_PERCENT, min_samples)
    if MAX_TEST_SAMPLES is not None:
        num_test_samples = min(MAX_TEST_SAMPLES, num_test_samples)
    num_test_samples -= existing_test_count
    num_val_bins = max(total_bins * VAL_PERCENT, min_bins)
    num_test_bins = max(total_bins * TEST_PERCENT, min_bins)
    if MAX_TEST_BINS is not None:
        num_test_bins = min(MAX_TEST_BINS, num_test_bins)
    num_test_bins -= existing_test_count

    add_to = validate_c
    bin_limit = num_val_bins
    sample_limit = num_val_samples
    label_count = 0
    bins: set[str] = set()
    last_index = 0
    for i, sample_bin in enumerate(bins_list):
        for sample in samples_by_bin[sample_bin]:
            bins.add(sample.bin_id)
            label_count += 1
            rec = rec_by_id[sample.rec_id]
            _add_sample(add_to, rec, sample)
            _remove_sample(dataset, sample)
        samples_by_bin[sample_bin] = []
        last_index = i
        if label_count >= sample_limit and len(bins) >= bin_limit:
            if no_test:
                break
            if add_to is validate_c:
                add_to = test_c
                if num_test_samples <= 0:
                    break
                sample_limit = num_test_samples
                bin_limit = num_test_bins
                label_count = 0
                bins = set()
            else:
                break
    leftovers = bins_list[last_index + 1 :]
    for sample_bin in leftovers:
        for sample in samples_by_bin[sample_bin]:
            rec = rec_by_id[sample.rec_id]
            _add_sample(train_c, rec, sample)
            _remove_sample(dataset, sample)
        samples_by_bin[sample_bin] = []


def split_randomly(
    dataset: AudioDataset,
    datasets=None,
    no_test: bool = False,
    seed: int | None = None,
) -> list[AudioDataset]:
    """Per-sorted-label bin-aware split (build.split_randomly,
    build.py:225-245)."""
    rng = random.Random(seed) if seed is not None else random
    if datasets is None:
        train = AudioDataset("train", dataset.config)
        validation = AudioDataset("validation", dataset.config)
        test = AudioDataset("test", dataset.config)
        datasets = [train, validation, test]
    for label in sorted(dataset.labels):
        split_label(dataset, datasets, label, no_test=no_test, rng=rng)
    return datasets


def split_by_file(dataset: AudioDataset, split: dict) -> list[AudioDataset]:
    """Pinned rec-id split (build.split_by_file, build.py:208-222)."""
    out = []
    for name in ("train", "validation", "test"):
        ds = AudioDataset(name, dataset.config)
        for clip_id in split["recs"].get(name, []):
            if clip_id in dataset.recs:
                rec = dataset.recs[clip_id]
                ds.add_recording(rec)
                dataset.recs.pop(clip_id, None)
        out.append(ds)
    return out


def undersample_ds(dataset: AudioDataset, rng=None) -> None:
    """Randomly drop samples of over-represented labels down toward 3/4 of
    the 9th-largest count (build.undersample_ds, build.py:472-531)."""
    rng = rng or np.random.default_rng()
    lbl_counts = dataset.get_counts()
    counts = sorted(lbl_counts.values(), reverse=True)
    if len(counts) <= 1:
        return
    target = counts[min(len(counts) - 1, 8)] * 3 / 4
    high = [l for l, c in lbl_counts.items() if c > target]
    for lbl in high:
        remove_chance = (lbl_counts[lbl] - target) / lbl_counts[lbl]
        recs = list(dataset.recs.values())
        random.shuffle(recs)
        for rec in recs:
            kept = []
            for sample in rec.samples:
                if lbl in sample.tags and rng.random() < remove_chance:
                    try:
                        dataset.samples.remove(sample)
                    except ValueError:
                        pass
                else:
                    kept.append(sample)
            rec.samples = kept


def oversample_ds(original_ds: AudioDataset, dataset: AudioDataset,
                  max_repeats: int = 1, rng=None) -> None:
    """Top up under-represented labels from the unused and small-stride
    pools, then by repeating samples (build.oversample_ds,
    build.py:539-676)."""
    rng = rng or np.random.default_rng()
    lbl_counts = dataset.get_counts()
    lbl_counts.pop("bird", None)
    lbl_counts.pop("noise", None)
    counts = sorted(lbl_counts.values(), reverse=True)
    if len(counts) <= 1:
        return
    target = counts[min(len(counts) - 1, 8)]
    low = {l: target - c for l, c in lbl_counts.items() if c < target}

    for lbl, missing in low.items():
        unused: dict[int, AudioSample] = {}
        small: dict[int, AudioSample] = {}
        for rec in original_ds.recs.values():
            if rec.id not in dataset.recs:
                continue
            for s in rec.unused_samples:
                if lbl in s.tags:
                    unused[s.id] = s
            for s in rec.small_strides:
                if lbl in s.tags:
                    small[s.id] = s

        for pool_store, pool in ((unused, "unused_samples"),
                                 (small, "small_strides")):
            if missing <= 0:
                break
            take = int(min(len(pool_store), missing))
            if take == 0:
                continue
            chosen = rng.choice(list(pool_store.values()), take,
                                replace=False)
            missing -= take
            for sample in chosen:
                sample.low_sample = True
                src = original_ds.recs[sample.rec_id]
                getattr(src, pool).remove(sample)
                dataset.recs[sample.rec_id].samples.append(sample)
                dataset.samples.append(sample)

        if missing > target / 2:
            # regenerate fresh jittered samples and repeat them
            repeat_sets: list[list[AudioSample]] = [[], [], []]
            for rec in dataset.recs.values():
                if lbl not in rec.human_tags:
                    continue
                s, ss, us = rec.get_samples(
                    dataset.segment_length, dataset.segment_stride,
                    for_label=lbl,
                )
                repeat_sets[0].extend(s)
                repeat_sets[1].extend(ss)
                repeat_sets[2].extend(us)
            if not repeat_sets[0]:
                continue
            repeat = 0
            while missing >= 1 and (max_repeats is None
                                    or repeat / 3 < max_repeats):
                pool = repeat_sets[repeat % 3]
                repeat += 1
                if not pool:
                    continue
                take = int(min(len(pool), missing))
                chosen = rng.choice(list(pool), take, replace=False)
                missing -= take
                for sample in chosen:
                    sample.low_sample = True
                    dataset.recs[sample.rec_id].samples.append(sample)
                    dataset.samples.append(sample)


def validate_datasets(datasets) -> None:
    """Leakage asserts: every bin and (non-oversampled) rec id appears in
    exactly one split (build.validate_datasets, build.py:817-837)."""
    train, validation, test = datasets
    train_bins = {s.bin_id for s in train.samples}
    val_bins = {s.bin_id for s in validation.samples}
    test_bins = {s.bin_id for s in test.samples}
    assert not (train_bins & val_bins), train_bins & val_bins
    assert not (train_bins & test_bins), train_bins & test_bins
    assert not (val_bins & test_bins), val_bins & test_bins

    train_recs = {str(s.rec_id) for s in train.samples if not s.low_sample}
    val_recs = {str(s.rec_id) for s in validation.samples if not s.low_sample}
    test_recs = {str(s.rec_id) for s in test.samples if not s.low_sample}
    assert not (train_recs & val_recs)
    assert not (train_recs & test_recs)
    assert not (val_recs & test_recs)


def write_training_meta(
    out_dir: str | Path, datasets, config=None, extra: dict | None = None
) -> Path:
    """training-meta.json (build.py:795-814)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    recs = {}
    for ds in datasets:
        rec_counts = {k: len(v) for k, v in ds.get_rec_counts().items()}
        counts[ds.name] = {
            "rec_counts": rec_counts,
            "sample_counts": ds.get_counts(),
        }
        recs[ds.name] = list(ds.recs.keys())
    meta = {
        "labels": sorted(datasets[0].labels),
        "type": "audio",
        "counts": counts,
        "recs": recs,
        "by_label": False,
        "relabbled": RELABEL,
    }
    if config is not None:
        meta.update(config_to_dict(config))
    if extra:
        meta.update(extra)
    path = out_dir / "training-meta.json"
    path.write_text(json.dumps(meta, indent=4))
    return path
