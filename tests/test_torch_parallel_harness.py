"""``train_run``'s data-parallel dispatch beside the mel families (the mel
families' runs are in tests/test_torch_harness.py), on two gloo CPU ranks
in one group: the ``merge`` run refuses ``num_data_shards > 1`` with JAX's
message (JAX ``harness.py:304-308``); the vector-input ``embeddings`` run
trains on one device, as in JAX (``:553-570``): rank 0 trains and writes,
rank 1 waits for its result, and both return the single-device run's
history; and a family behind the trainable PCEN frontend keeps the
single-device run's test predictions, tails included.  The corpora are
tests/test_torch_harness.py's 5 s corpus with features and embeddings, and
its 3 s corpus with splits of 11, 8 and 7 clips.
"""

import json

import numpy as np
import pytest
import torch

from audio_training_tpu.config import TrainConfig as JTrainConfig
from audio_training_tpu.train import harness as jharness
from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.parallel.multihost import run_ranks
from audio_training_tpu_torch.train import harness

import torch_dp_ranks
from test_torch_harness import GEOMETRY, write_corpus, write_feature_corpus

torch.set_num_threads(2)

TRAIN = dict(batch_size=4, learning_rate=1e-3, epochs=1,
             compute_dtype="float32")
STEPS = 2
# a family behind the trainable PCEN frontend, whose min-max is over the
# whole batch; learning rate 0, so that the test predictions (after BN
# re-estimation) depend on the evaluation passes alone; splits whose
# BN-re-estimation (train) and test tails of 3 the two ranks do not divide
PCEN_MODEL = "mobilenet"
PCEN_TRAIN = dict(model_name=PCEN_MODEL, batch_size=4, learning_rate=0.0,
                  epochs=1, compute_dtype="float32", bn_reestimate=True)
PCEN_SPLITS = {"train": 11, "validation": 8, "test": 7}


def _jax_merge_message() -> str:
    with pytest.raises(ValueError) as exc:
        jharness._train_merge_run(
            None, None, None, None, None, None,
            JTrainConfig(model_name="merge", num_data_shards=2), None, None,
            None, None, None)
    return str(exc.value)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_feature_corpus(
        tmp_path_factory.mktemp("features"),
        FeaturizerConfig(**GEOMETRY, segment_length=5.0))


@pytest.fixture(scope="module")
def pcen_corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("pcen"),
                        FeaturizerConfig(**GEOMETRY), splits=PCEN_SPLITS)


@pytest.fixture(scope="module")
def results(corpus, pcen_corpus, tmp_path_factory):
    """Both ranks, in one group: the merge run, the embeddings run, then
    the PCEN family's run."""
    root = tmp_path_factory.mktemp("dp")
    featurizer = FeaturizerConfig(**GEOMETRY, segment_length=5.0)
    runs = [([corpus], root / name,
             dict(TRAIN, model_name=name, num_data_shards=2),
             dict(featurizer=featurizer, steps_per_epoch=STEPS))
            for name in ("merge", "embeddings")]
    runs.append(([pcen_corpus], root / PCEN_MODEL,
                 dict(PCEN_TRAIN, num_data_shards=2),
                 dict(featurizer=FeaturizerConfig(**GEOMETRY),
                      steps_per_epoch=1)))
    out = run_ranks(torch_dp_ranks.train_runs_rank, 2, args=(runs,),
                    timeout_s=120.0)
    return {name: [r[i] for r in out]
            for i, name in enumerate(("merge", "embeddings", PCEN_MODEL))}, root


def test_merge_run_refuses_data_parallel_with_jaxs_message(results):
    want = _jax_merge_message()
    assert "merge training does not implement mesh data-parallelism" in want
    for r in results[0]["merge"]:
        assert r == {"error": want}


def test_vector_run_trains_on_one_device(results, corpus, tmp_path):
    """The embeddings run under a 2-rank mesh is the single-device run:
    same history on both ranks, one run directory with its artifacts."""
    single = harness.train_run(
        [corpus], "one", checkpoint_root=tmp_path,
        train_cfg=TrainConfig(**TRAIN, model_name="embeddings"),
        featurizer=FeaturizerConfig(**GEOMETRY, segment_length=5.0),
        steps_per_epoch=STEPS, device="cpu")
    ranks = results[0]["embeddings"]
    for r in ranks:
        assert r["labels"] == single.labels
        assert r["history"].keys() == single.history.keys()
        for k in ("loss", "val_loss", "auc"):
            np.testing.assert_allclose(r["history"][k], single.history[k],
                                       rtol=1e-6)
    files = ranks[0]["files"]
    for name in ("chkpt.pt", "history.json", "metadata.txt",
                 "training-log.csv"):
        assert name in files, name
    assert ranks[1]["files"] == files  # rank 1 returned after rank 0 wrote
    meta_hist = json.loads((tmp_path / "one" / "history.json").read_text())
    assert meta_hist["loss"] == single.history["loss"]


def test_pcen_family_run_keeps_the_single_device_test_predictions(
        results, pcen_corpus, tmp_path):
    """A PCEN-frontend family under a 2-rank mesh: the BN re-estimation and
    the test confusion run each batch's PCEN min-max and BatchNorm moments
    over the whole batch and keep the tails that the ranks do not divide,
    as JAX's unsharded passes do, so the test predictions and metrics are
    the single-device run's (predictions within 2e-5 / 2e-6, as the
    sharded Predictor is held)."""
    got, root = results
    single = harness.train_run(
        [pcen_corpus], "one", checkpoint_root=tmp_path,
        train_cfg=TrainConfig(**PCEN_TRAIN),
        featurizer=FeaturizerConfig(**GEOMETRY), steps_per_epoch=1,
        device="cpu")

    def raw(run_dir):
        with (run_dir / "confusion-raw.npy").open("rb") as f:
            np.load(f)
            return np.load(f), np.load(f)

    want_pred, want_true = raw(tmp_path / "one")
    pred, true = raw(root / PCEN_MODEL / "dp")
    assert pred.shape == want_pred.shape
    assert len(pred) == PCEN_SPLITS["test"]
    np.testing.assert_array_equal(true, want_true)
    np.testing.assert_allclose(pred, want_pred, rtol=2e-5, atol=2e-6)
    for r in got[PCEN_MODEL]:
        assert r["test_metrics"]["test_samples"] == PCEN_SPLITS["test"]
        assert r["test_metrics"] == single.test_metrics
