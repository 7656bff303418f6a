"""Label ontology: relabel map and label groupings.

Equivalent capability to the reference ``birdsconfig.py``, but immutable and
data-driven: the raw ontology lives in ``assets/ontology.json`` and this module
materializes it into a frozen ``Ontology`` object (the reference instead
mutates module globals, ``birdsconfig.py:190-203``).

A copy of ``audio_training_tpu/taxonomy/ontology.py``: the port keeps its
own so that it never imports the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from pathlib import Path

from audio_training_tpu_torch.taxonomy.ebird import ONTOLOGY_JSON, get_all_birds


@dataclass(frozen=True)
class Ontology:
    relabel_map: dict[str, str]
    bird_train_labels: tuple[str, ...]
    all_birds: tuple[str, ...]
    noise_labels: tuple[str, ...]
    animal_labels: tuple[str, ...]
    insect_labels: tuple[str, ...]
    human_labels: tuple[str, ...]
    extra_labels: tuple[str, ...]
    other_labels: tuple[str, ...] = ()

    def with_relabel_map(self, relabel_map: dict[str, str]) -> "Ontology":
        """Functional override of the merge map (vs tfdataset.set_merge_labels)."""
        return replace(self, relabel_map=dict(relabel_map))

    def with_extra_train_labels(self, labels: list[str]) -> "Ontology":
        extra = [l for l in labels if l not in self.bird_train_labels]
        return replace(
            self, bird_train_labels=tuple(list(self.bird_train_labels) + extra)
        )


def load_ontology(path: str | Path | None = None) -> Ontology:
    """Build the full ontology.

    Extends the base relabel map so every non-canonical noise/human/other
    label collapses into ``noise``/``human``/``other``, mirroring
    ``birdsconfig.py:190-203``.
    """
    data = json.loads(Path(path or ONTOLOGY_JSON).read_text())
    relabel = dict(data["relabel_map"])
    for l in data["noise_labels"]:
        if l != "noise":
            relabel[l] = "noise"
    for l in data["human_labels"]:
        if l != "human":
            relabel[l] = "human"
    for l in data.get("other_labels", []):
        if l != "other":
            relabel[l] = "other"

    all_birds = list(get_all_birds())
    for extra in data["extra_birds"]:
        if extra not in all_birds:
            all_birds.append(extra)

    return Ontology(
        relabel_map=relabel,
        bird_train_labels=tuple(data["bird_train_labels"]),
        all_birds=tuple(all_birds),
        noise_labels=tuple(data["noise_labels"]),
        animal_labels=tuple(data["animal_labels"]),
        insect_labels=tuple(data["insect_labels"]),
        human_labels=tuple(data["human_labels"]),
        extra_labels=tuple(data["extra_labels"]),
        other_labels=tuple(data.get("other_labels", [])),
    )
