"""The port's vector-input streams and random forest against the JAX
package's, on the CPU: ``EmbeddingStream`` (with and without z-norm,
windowed embeddings averaged), ``FeatureStream`` (with its sample filters)
and ``resample_per_label`` give items bitwise equal to JAX's on the same
shards and seed; ``train_random_forest`` at ``backend="sklearn"`` and the
same ``random_state`` gives JAX's forest: equal predictions and
accuracies.  The shards are written by the port's own writer; the label
spaces are each package's ``init_labels`` of the same corpus.
"""

import json
import pickle

import numpy as np
import pytest

from audio_training_tpu.data import embeddings as jemb
from audio_training_tpu.train import harness as jharness
from audio_training_tpu_torch.config import TrainConfig
from audio_training_tpu_torch.data import (
    EMBEDDING_DIM,
    MID_FEATURES_SHAPE,
    SHORT_FEATURES_SHAPE,
    EmbeddingStream,
    FeatureStream,
    SampleRecord,
    encode_sample,
    load_znorm,
    resample_per_label,
    write_tfrecords,
)
from audio_training_tpu_torch.train import harness

SPECIES = ["kiwi", "morepo2", "tui1", "rain"]


def _records(split, n, rng):
    """Records of each kind the streams meet: full ones, 3-window
    embeddings, a wrong-sized embedding, no features, an unknown tag, a
    low sample and a generic-bird-only one."""
    recs = []
    for i in range(n):
        tag = SPECIES[i % len(SPECIES)]
        shift = float(i % len(SPECIES)) - 1.5
        emb = (rng.standard_normal(EMBEDDING_DIM) + shift).astype(np.float32)
        if i % 7 == 3:
            emb = rng.standard_normal((3, EMBEDDING_DIM)).astype(np.float32)
        elif i % 11 == 5:
            emb = rng.standard_normal(100).astype(np.float32)
        feats = {}
        if i % 9 != 4:
            feats = dict(
                short_features=(0.1 * rng.standard_normal(SHORT_FEATURES_SHAPE)
                                + shift).astype(np.float32),
                mid_features=rng.standard_normal(MID_FEATURES_SHAPE).astype(
                    np.float32))
        tags = [tag] if i % 13 != 6 else ["unknown-tag"]
        if i % 17 == 8:
            tags = ["bird"]
        recs.append(encode_sample(SampleRecord(
            raw=np.zeros(0, np.float32), tags=tags, rec_id=f"{split}{i}",
            low_sample=int(i % 5 == 2), embeddings=emb, **feats)))
    return recs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vectors")
    rng = np.random.default_rng(0)
    for split, n in (("train", 60), ("validation", 24)):
        recs = _records(split, n, rng)
        for s in range(3):
            write_tfrecords(root / split / f"{split}-{s}.tfrecord",
                            recs[s::3])
    per = {sp: 15 for sp in SPECIES}
    (root / "training-meta.json").write_text(json.dumps({
        "labels": SPECIES, "type": "audio", "counts": {
            split: {"sample_counts": per, "rec_counts": per}
            for split in ("train", "validation")}}))
    return root


def _spaces(corpus):
    return (harness.init_labels([corpus])[0],
            jharness.init_labels([corpus])[0])


def _shards(corpus, split="train"):
    return sorted((corpus / split).glob("*.tfrecord"))


def _assert_items_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("znorm", [False, True])
def test_embedding_stream_matches_jax(corpus, tmp_path, znorm):
    space, jspace = _spaces(corpus)
    stats = None
    if znorm:
        rng = np.random.default_rng(1)
        path = tmp_path / "zvalues.txt"
        np.savetxt(path, np.stack([rng.normal(0, 1, EMBEDDING_DIM),
                                   rng.uniform(0, 2, EMBEDDING_DIM)]))
        stats = load_znorm(path)
        for a, b in zip(stats, jemb.load_znorm(path)):
            np.testing.assert_array_equal(a, b)
    got = list(EmbeddingStream(_shards(corpus), space, znorm=stats, seed=3))
    want = list(jemb.EmbeddingStream(_shards(corpus), jspace, znorm=stats,
                                     seed=3))
    _assert_items_equal(got, want)
    # a looping stream's second pass reshuffles as JAX's does
    got = [x for _, x in zip(range(90), EmbeddingStream(
        _shards(corpus), space, loop=True, seed=4))]
    want = [x for _, x in zip(range(90), jemb.EmbeddingStream(
        _shards(corpus), jspace, loop=True, seed=4))]
    _assert_items_equal(got, want)


@pytest.mark.parametrize("filters", [
    {}, {"exclude_low_samples": True, "drop_bird_only": True}])
def test_feature_stream_matches_jax(corpus, filters):
    space, jspace = _spaces(corpus)
    got = list(FeatureStream(_shards(corpus), space, seed=5, **filters))
    want = list(jemb.FeatureStream(_shards(corpus), jspace, seed=5,
                                   **filters))
    _assert_items_equal(got, want)
    if filters:
        assert len(got) < len(list(FeatureStream(_shards(corpus), space)))


@pytest.mark.parametrize("target", [None, 12])
def test_resample_per_label_matches_jax(corpus, target):
    space, _ = _spaces(corpus)
    items = list(EmbeddingStream(_shards(corpus), space, seed=6))
    got = resample_per_label(items, target=target, seed=7)
    _assert_items_equal(got, jemb.resample_per_label(items, target=target,
                                                     seed=7))


def test_train_random_forest_matches_jax(corpus, tmp_path):
    """The same forest as JAX's on the same features: equal predictions on
    the validation split, equal accuracies, the same metadata entries."""
    kw = dict(n_estimators=20, backend="sklearn")
    got = harness.train_random_forest(
        [corpus], "rf", checkpoint_root=tmp_path / "port",
        train_cfg=TrainConfig(model_name="rf-features", seed=2), **kw)
    from audio_training_tpu.config import TrainConfig as JTrainConfig

    want = jharness.train_random_forest(
        [corpus], "rf", checkpoint_root=tmp_path / "jax",
        train_cfg=JTrainConfig(model_name="rf-features", seed=2), **kw)
    assert got.labels == want.labels
    assert got.history == want.history
    space, _ = _spaces(corpus)
    x = np.stack([np.concatenate([s.ravel(), m.ravel()]) for s, m, _ in
                  FeatureStream(_shards(corpus, "validation"), space)])
    models = [pickle.loads((r.run_dir / "random_forest.pkl").read_bytes())
              for r in (got, want)]
    assert models[0]["labels"] == models[1]["labels"]
    np.testing.assert_array_equal(models[0]["model"].predict(x),
                                  models[1]["model"].predict(x))
    np.testing.assert_array_equal(models[0]["model"].predict_proba(x)[0],
                                  models[1]["model"].predict_proba(x)[0])
    metas = [json.loads((r.run_dir / "metadata.txt").read_text())
             for r in (got, want)]
    for key in ("rf_history", "rf_backend", "labels", "name"):
        assert metas[0][key] == metas[1][key], key
