"""Common-name <-> eBird-id mapping built from the bundled CSV assets.

Capability parity with the reference ``utils.py:4-73``: the 88-species
``classes.csv`` plus the full eBird 2024 taxonomy provide the universe of bird
labels and the name->species-code lookup, with a set of project-specific
overrides (stored as data in ``assets/ontology.json``).

A copy of ``audio_training_tpu/taxonomy/ebird.py``: the port keeps its
own so that it never imports the JAX package.
"""

from __future__ import annotations

import csv
import functools
import json
from pathlib import Path

ASSETS_DIR = Path(__file__).resolve().parent.parent / "assets"
CLASSES_CSV = ASSETS_DIR / "classes.csv"
TAXONOMY_CSV = ASSETS_DIR / "eBird_taxonomy_v2024.csv"
ONTOLOGY_JSON = ASSETS_DIR / "ontology.json"


def _norm(name: str) -> str:
    return name.lower().replace(" ", "-")


@functools.lru_cache(maxsize=None)
def get_all_birds() -> tuple[str, ...]:
    """Sorted union of species codes from both CSVs (utils.py:4-19)."""
    birds: set[str] = set()
    with open(TAXONOMY_CSV, newline="") as f:
        reader = csv.reader(f, delimiter=",", quotechar="|")
        next(reader)
        for row in reader:
            birds.add(row[2])
    with open(CLASSES_CSV, newline="") as f:
        reader = csv.reader(f, delimiter=",", quotechar="|")
        next(reader)
        for row in reader:
            birds.add(row[2])
    return tuple(sorted(birds))


@functools.lru_cache(maxsize=None)
def get_label_to_ebird_map() -> dict[str, str]:
    """normalized common/extra name -> eBird species code (utils.py:22-58)."""
    ebird_map: dict[str, str] = {}
    with open(CLASSES_CSV, newline="") as f:
        reader = csv.reader(f, delimiter=",", quotechar="|")
        next(reader)
        for row in reader:
            ebird_map[_norm(row[1])] = row[2]
            ebird_map[_norm(row[4])] = row[2]
    with open(TAXONOMY_CSV, newline="") as f:
        reader = csv.reader(f, delimiter=",", quotechar='"')
        next(reader)
        for row in reader:
            ebird_map[_norm(row[4])] = row[2]
            ebird_map[_norm(row[8])] = row[2]
    overrides = json.loads(ONTOLOGY_JSON.read_text())["ebird_overrides"]
    ebird_map.update(overrides)
    return ebird_map


def get_ebird_id(label: str, ebird_map: dict[str, str] | None = None) -> str:
    if ebird_map is None:
        ebird_map = get_label_to_ebird_map()
    return ebird_map.get(_norm(label), label)


@functools.lru_cache(maxsize=None)
def get_ebird_ids_to_labels() -> dict[str, list[str]]:
    """Reverse map: eBird id -> list of common names (utils.py:65-73)."""
    reverse: dict[str, list[str]] = {}
    for label, ebird_id in get_label_to_ebird_map().items():
        reverse.setdefault(ebird_id, []).append(label)
    return reverse
