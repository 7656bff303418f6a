"""The port's taxonomy (eBird maps, ontology, label space) and
``train/harness.init_labels`` against the JAX package's, exactly.

The label-space cases are ``tests/test_harness.py:10-75``'s
``training-meta.json`` files in each ``init_labels`` mode; the
``LabelSpace`` fields (``labels``, ``source_labels``, ``remap``,
``extra``, ``excluded``) must be equal, as must the ontology each mode
leaves behind.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from audio_training_tpu.taxonomy import ebird as jebird
from audio_training_tpu.taxonomy import labels as jlabels
from audio_training_tpu.taxonomy import ontology as jontology
from audio_training_tpu.train import harness as jharness
from audio_training_tpu_torch.taxonomy import ebird, labels, ontology
from audio_training_tpu_torch.train import harness

torch.set_num_threads(2)

ASSETS = ("classes.csv", "eBird_taxonomy_v2024.csv", "ebird_species.json",
          "ontology.json")


@pytest.mark.parametrize("name", ASSETS)
def test_assets_are_the_jax_packages(name):
    assert ((ebird.ASSETS_DIR / name).read_bytes()
            == (jebird.ASSETS_DIR / name).read_bytes())


@pytest.mark.parametrize("fn", ["get_all_birds", "get_label_to_ebird_map",
                                "get_ebird_ids_to_labels"])
def test_ebird_maps_match_jax(fn):
    assert getattr(ebird, fn)() == getattr(jebird, fn)()


@pytest.mark.parametrize("name", ["morepork", "Tui", "North Island Kiwi",
                                  "kiwi", "rain", "not a bird", "bird",
                                  "whiteh1", "Song Thrush"])
def test_get_ebird_id_matches_jax(name):
    assert ebird.get_ebird_id(name) == jebird.get_ebird_id(name)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_ontology_matches_jax():
    got, want = ontology.load_ontology(), jontology.load_ontology()
    assert _fields(got) == _fields(want)
    extra = ["whiteh1", "kiwi"]
    assert (_fields(got.with_extra_train_labels(extra))
            == _fields(want.with_extra_train_labels(extra)))


def _space_fields(space) -> dict:
    d = space.to_dict()
    d["remap_dtype"] = str(space.remap.dtype)
    d["extra_dtype"] = str(space.extra.dtype)
    return d


LABEL_SETS = [
    ["kiwi", "morepo2", "rain", "human"],
    ["kiwi", "whiteh1"],
    ["kiwi", "morepo2", "tui1", "bird", "noise", "insect", "dog"],
    ["morepo2", "Rain", "Breathing", "false-positive", "rooster"],
]


@pytest.mark.parametrize("generic", [True, False])
@pytest.mark.parametrize("label_set", LABEL_SETS)
def test_label_space_functions_match_jax(label_set, generic):
    ont, jont = ontology.load_ontology(), jontology.load_ontology()
    excl = labels.get_excluded_labels(ont, list(label_set))
    assert excl == jlabels.get_excluded_labels(jont, list(label_set))
    got = labels.get_remappings(ont, label_set, excl,
                                use_generic_bird=generic)
    want = jlabels.get_remappings(jont, label_set, excl,
                                  use_generic_bird=generic)
    assert got == want
    space = labels.build_label_space(ont, label_set, use_generic_bird=generic)
    jspace = jlabels.build_label_space(jont, label_set,
                                       use_generic_bird=generic)
    assert _space_fields(space) == _space_fields(jspace)
    back = labels.LabelSpace.from_dict(space.to_dict())
    assert _space_fields(back) == _space_fields(space)
    sid = list(range(len(space.source_labels)))[:2]
    np.testing.assert_array_equal(space.one_hot(sid), jspace.one_hot(sid))


def _write_meta(tmp_path, label_set, counts=None):
    """``tests/test_harness.py:10-22``'s training-meta.json."""
    counts = counts or {l: 100 for l in label_set}
    meta = {
        "labels": label_set,
        "counts": {
            "train": {"sample_counts": counts,
                      "rec_counts": {l: 60 for l in label_set}},
            "validation": {"sample_counts": {l: 10 for l in label_set}},
            "test": {"sample_counts": {}},
        },
    }
    (tmp_path / "training-meta.json").write_text(json.dumps(meta))
    return tmp_path


# (labels, init_labels keyword arguments): the cases of
# tests/test_harness.py:25-75, and the generic-bird switch
INIT_CASES = [
    (["kiwi", "morepork", "rain", "human"], {}),
    (["kiwi", "whiteh1"], {}),
    (["kiwi", "morepork", "rain", "dog"], {"only_features": True}),
    (["kiwi", "morepork", "rain"], {"morepork_model": True}),
    (["kiwi", "morepork", "rain", "human"], {"use_generic_bird": False}),
]


@pytest.mark.parametrize("label_set,kwargs", INIT_CASES,
                         ids=["default", "count_admission", "only_features",
                              "morepork_model", "no_generic_bird"])
def test_init_labels_matches_jax(tmp_path, label_set, kwargs):
    _write_meta(tmp_path, label_set)
    space, ont, meta = harness.init_labels([tmp_path], **kwargs)
    jspace, jont, jmeta = jharness.init_labels([tmp_path], **kwargs)
    assert _space_fields(space) == _space_fields(jspace)
    assert _fields(ont) == _fields(jont)
    assert meta == jmeta


def test_init_labels_admits_by_count_over_two_dirs(tmp_path):
    """Count admission folds over every data dir, as in JAX."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = _write_meta(tmp_path / "a", ["kiwi", "whiteh1"])
    b = _write_meta(tmp_path / "b", ["tui", "whiteh1"],
                    {"tui": 100, "whiteh1": 3})
    space, ont, _ = harness.init_labels([a, b])
    jspace, jont, _ = jharness.init_labels([a, b])
    assert _space_fields(space) == _space_fields(jspace)
    assert ont.bird_train_labels == jont.bird_train_labels
