"""The label-space state machine.

Pure-host reimplementation of the reference's label logic, which is spread
over ``tfdataset.py:68-172`` (``set_specific_by_count`` /
``get_excluded_labels``) and ``tfdataset.py:341-421`` (``get_remappings``).
The output is a :class:`LabelSpace` whose integer remap table replaces the
in-graph ``tf.lookup.StaticHashTable`` (``tfdataset.py:546-578``): string
lookup happens once on the host, and the device only ever sees int32 indices.

A copy of ``audio_training_tpu/taxonomy/labels.py``: the port keeps its
own so that it never imports the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from audio_training_tpu_torch.taxonomy.ontology import Ontology

log = logging.getLogger(__name__)


def admit_labels_by_count(
    ontology: Ontology, meta: dict
) -> tuple[Ontology, list[str]]:
    """Admit extra bird labels that have enough data.

    Mirrors ``tfdataset.set_specific_by_count`` (``tfdataset.py:68-156``):
    merged-label counts are accumulated through the relabel map, then any bird
    with >50 train samples, >50 train recordings and >2 validation samples is
    added to the trainable set.  Returns a new ontology (with the grown
    ``bird_train_labels``) plus the list of labels that had data.
    """
    counts = meta["counts"]
    training = dict(counts["train"]["sample_counts"])
    training_rec = dict(counts["train"]["rec_counts"])
    validation = dict(counts["validation"]["sample_counts"])

    # fold merged labels into their target's counts
    for dataset in (training, training_rec, validation):
        for k, v in ontology.relabel_map.items():
            if k in dataset:
                total = dataset[k] + dataset.get(v, 0)
                dataset[k] = total
                if v in dataset:
                    dataset[v] = total

    labels_with_data = []
    admitted = list(ontology.bird_train_labels)
    for label, count in training.items():
        rec_count = training_rec.get(label, 0)
        if label not in validation:
            continue
        val_count = validation[label]
        if count > 50 and rec_count > 50 and val_count > 2:
            labels_with_data.append(label)
            if label not in ontology.all_birds and label not in ontology.relabel_map:
                log.info("Have data for %s but not included", label)
            if label in ontology.all_birds and label not in admitted:
                admitted.append(label)
                log.info(
                    "Using %s: samples=%s recs=%s val=%s",
                    label,
                    count,
                    rec_count,
                    val_count,
                )
    new_ont = ontology.with_extra_train_labels(admitted)
    return new_ont, labels_with_data


def get_excluded_labels(ontology: Ontology, labels: list[str]) -> list[str]:
    """Labels to drop from training (``tfdataset.py:158-172``)."""
    excluded: list[str] = []
    for l in labels:
        if l in ontology.noise_labels and "noise" in labels:
            continue
        elif l in ontology.human_labels and "human" in labels:
            continue
        elif l in ontology.other_labels and "other" in labels:
            continue
        elif (
            l not in ontology.bird_train_labels and l not in ontology.extra_labels
        ):
            excluded.append(l)
    for k, v in ontology.relabel_map.items():
        if v not in excluded and k in excluded:
            excluded.remove(k)
    return excluded


def get_remappings(
    ontology: Ontology,
    labels: list[str],
    excluded_labels: list[str],
    keep_excluded_in_extra: bool = True,
    use_generic_bird: bool = True,
) -> tuple[dict[str, int], dict[str, int], list[str]]:
    """Build (extra_label_map, remap_dict, new_labels).

    Faithful port of ``tfdataset.get_remappings`` (``tfdataset.py:341-421``):

    * excluded labels map to -1;
    * merged labels (relabel map) map to their target's index;
    * non-canonical noise/human/other labels map to the canonical index;
    * every *trainable* specific bird additionally activates the generic
      ``bird`` output via ``extra_label_map`` (so a one-hot of a specific
      species also lights up ``bird``), while non-trainable birds remap to
      ``bird`` outright.
    """
    excluded_labels = list(excluded_labels)
    extra_label_map: dict[str, int] = {}
    re_dic: dict[str, int] = {}
    new_labels = list(labels)

    for excluded in excluded_labels:
        if excluded in new_labels:
            new_labels.remove(excluded)

    merge_targets = list(ontology.relabel_map.values())
    for k, v in ontology.relabel_map.items():
        if k in new_labels and v not in new_labels:
            if v in ("noise", "human"):
                excluded_labels.append(k)
            else:
                new_labels.append(v)
    new_labels.sort()
    for label in ontology.relabel_map.keys():
        if label in new_labels and label not in merge_targets:
            new_labels.remove(label)

    for l in labels:
        if l in excluded_labels:
            re_dic[l] = -1
        else:
            if l in ontology.relabel_map and ontology.relabel_map[l] in new_labels:
                re_dic[l] = new_labels.index(ontology.relabel_map[l])
            else:
                re_dic[l] = new_labels.index(l)
    if not use_generic_bird:
        re_dic["bird"] = -1

    if not keep_excluded_in_extra:
        labels = list(new_labels)

    for l in labels:
        if l in excluded_labels:
            continue
        remap_label = None
        if l in ontology.noise_labels:
            if "noise" in new_labels:
                remap_label = "noise"
        elif l in ontology.human_labels:
            if "human" in new_labels:
                remap_label = "human"
        elif l in ontology.other_labels:
            if "other" in new_labels:
                remap_label = "other"
        elif l in ontology.all_birds:
            if not use_generic_bird or l == "bird":
                continue
            if "bird" not in new_labels:
                # The reference assumes "bird" was admitted by count into
                # BIRD_TRAIN_LABELS (tfdataset.py:147-148) and would crash
                # here otherwise; we skip the generic-bird coupling instead.
                continue
            if l in ontology.bird_train_labels:
                extra_label_map[l] = new_labels.index("bird")
            else:
                remap_label = "bird"
        else:
            continue
        if l == remap_label or remap_label is None:
            continue
        re_dic[l] = new_labels.index(remap_label)
    return extra_label_map, re_dic, new_labels


@dataclass(frozen=True)
class LabelSpace:
    """Resolved label space for one training run.

    ``source_labels`` is the ordered label vocabulary found in the dataset
    metadata; ``labels`` is the final output vocabulary; ``remap`` /
    ``extra`` are dense int32 tables indexed by source-label id (-1 = drop /
    no extra), ready to be used inside jit for one-hot construction.
    """

    source_labels: tuple[str, ...]
    labels: tuple[str, ...]
    remap: np.ndarray  # (num_source,) int32, -1 = excluded
    extra: np.ndarray  # (num_source,) int32, -1 = no extra (generic-bird) hit
    excluded: tuple[str, ...] = ()

    @property
    def num_labels(self) -> int:
        return len(self.labels)

    def index_of(self, label: str) -> int:
        return self.labels.index(label)

    def one_hot(self, source_ids: list[int]) -> np.ndarray:
        """Multi-hot target for a sample tagged with the given source ids."""
        y = np.zeros(self.num_labels, np.float32)
        for sid in source_ids:
            tgt = self.remap[sid]
            if tgt >= 0:
                y[tgt] = 1.0
            ex = self.extra[sid]
            if ex >= 0:
                y[ex] = 1.0
        return y

    def to_dict(self) -> dict:
        return {
            "source_labels": list(self.source_labels),
            "labels": list(self.labels),
            "remap": self.remap.tolist(),
            "extra": self.extra.tolist(),
            "excluded": list(self.excluded),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LabelSpace":
        return cls(
            source_labels=tuple(d["source_labels"]),
            labels=tuple(d["labels"]),
            remap=np.asarray(d["remap"], np.int32),
            extra=np.asarray(d["extra"], np.int32),
            excluded=tuple(d.get("excluded", ())),
        )


def build_label_space(
    ontology: Ontology,
    labels: list[str],
    excluded_labels: list[str] | None = None,
    use_generic_bird: bool = True,
) -> LabelSpace:
    """End-to-end label-space construction for a run."""
    if excluded_labels is None:
        excluded_labels = get_excluded_labels(ontology, labels)
        if use_generic_bird and "bird" in excluded_labels:
            # "bird" is normally admitted by sample count at runtime
            # (tfdataset.py:147-148); keep it when generic-bird mode is on.
            excluded_labels.remove("bird")
    extra_map, re_dic, new_labels = get_remappings(
        ontology, labels, excluded_labels, use_generic_bird=use_generic_bird
    )
    source = sorted(set(labels) | set(re_dic.keys()))
    remap = np.full(len(source), -1, np.int32)
    extra = np.full(len(source), -1, np.int32)
    for i, l in enumerate(source):
        if l in re_dic:
            remap[i] = re_dic[l]
        elif l in new_labels:
            remap[i] = new_labels.index(l)
        if l in extra_map:
            extra[i] = extra_map[l]
    return LabelSpace(
        source_labels=tuple(source),
        labels=tuple(new_labels),
        remap=remap,
        extra=extra,
        excluded=tuple(excluded_labels),
    )
