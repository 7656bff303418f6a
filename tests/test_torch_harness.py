"""The port's run harness and training CLI: ``train_run`` from a built
corpus on the CPU, ``save_metadata`` and ``cli/train.parse_args`` against
the JAX package's, the CLI's runs of dual-badwinner2, merge, cnn-features,
embeddings and rf-features (on a 5 s corpus whose records also hold
features and embeddings), and the paths that are not ported yet.

The corpus is a tiny one written by the port's own writer (GZIP shards and
a ``training-meta.json``): 8 kHz, 3 s clips, n_fft 512, hop 100, 96 mels
(off K1's n_fft 4096 path, so the CPU featurizer runs), three species as
tones over noise.  ``train_run`` takes B=4, 1 epoch x 2 steps, with
``bn_reestimate`` and ``epoch_confusion`` on.  Its label space must equal
JAX ``init_labels`` on the same corpus, its run directory must hold every
artifact (metadata, checkpoints, history, the event file, the weight
histograms, the per-epoch and test confusions), and the port's
``cli/predict.load_predictor`` must load it.
"""

import json

import numpy as np
import pytest
import torch

from audio_training_tpu.cli import train as jcli
from audio_training_tpu.config import FeaturizerConfig as JFeaturizerConfig
from audio_training_tpu.taxonomy.ontology import load_ontology as jload
from audio_training_tpu.train import harness as jharness
from audio_training_tpu.train import metadata as jmetadata
from audio_training_tpu_torch.cli import predict
from audio_training_tpu_torch.cli import train as cli
from audio_training_tpu_torch.config import (
    FeaturizerConfig,
    TrainConfig,
    config_to_dict,
)
from audio_training_tpu_torch.data import SampleRecord, encode_sample
from audio_training_tpu_torch.data import write_tfrecords
from audio_training_tpu_torch.taxonomy.ontology import load_ontology
from audio_training_tpu_torch.train import harness, metadata
from audio_training_tpu_torch.utils.tensorboard import read_events

torch.set_num_threads(2)

GEOMETRY = dict(sr=8000, n_fft=512, hop_length=100, n_mels=96, fmin=100.0,
                fmax=3500.0)
SPECIES = ["kiwi", "morepo2", "tui1"]
FREQS = [1200.0, 500.0, 3200.0]
SPLITS = {"train": 16, "validation": 8, "test": 8}
TRAIN = dict(model_name="badwinner2", batch_size=4, learning_rate=1e-3,
             epochs=1, compute_dtype="float32", bn_reestimate=True,
             epoch_confusion=True)


def write_corpus(root, cfg, shards=2, seed=0, splits=SPLITS):
    """Tone-band clips over noise (``splits`` maps each split to its clip
    count), ``shards`` GZIP shards a split, and the build's
    ``training-meta.json`` (labels, counts, featurizer)."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.samples_per_clip) / cfg.sr
    counts = {}
    for split, n in splits.items():
        recs = []
        for i in range(n):
            k = i % len(SPECIES)
            raw = (0.05 * rng.standard_normal(t.size)
                   + 0.8 * np.sin(2 * np.pi * FREQS[k] * t
                                  + rng.uniform(0, 6.3)))
            recs.append(encode_sample(SampleRecord(
                raw=raw.astype(np.float32), tags=[SPECIES[k]],
                rec_id=f"{split}{i}", sr=cfg.sr)))
        for s in range(shards):
            write_tfrecords(root / split / f"{split}-{s}.tfrecord",
                            recs[s::shards])
        per = {sp: len(range(j, n, len(SPECIES)))
               for j, sp in enumerate(SPECIES)}
        counts[split] = {"sample_counts": per, "rec_counts": per}
    meta = {"labels": SPECIES, "type": "audio", "counts": counts,
            **config_to_dict(cfg)}
    (root / "training-meta.json").write_text(json.dumps(meta, indent=4))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"),
                        FeaturizerConfig(**GEOMETRY))


@pytest.fixture(scope="module")
def run(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    result = harness.train_run(
        [corpus], "tiny", checkpoint_root=root,
        train_cfg=TrainConfig(**TRAIN), featurizer=FeaturizerConfig(**GEOMETRY),
        steps_per_epoch=2, device="cpu")
    return result


@pytest.fixture(scope="module")
def one_step_run(corpus, tmp_path_factory):
    """The single-device run that the data-parallel runs are held to: one
    step, so that its train loss is taken before any update."""
    return harness.train_run(
        [corpus], "one", checkpoint_root=tmp_path_factory.mktemp("one"),
        train_cfg=TrainConfig(**TRAIN), featurizer=FeaturizerConfig(**GEOMETRY),
        steps_per_epoch=1, device="cpu")


def assert_history_matches(hist, want):
    """The train loss (one step, before any update) within 1e-5; the
    validation loss, after Adam's first update, within 1e-3: that update
    is +-lr an element, and the f32 rounding of a gradient element near 0,
    which differs between one process and two, can flip its sign."""
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(hist["val_loss"], want["val_loss"], rtol=1e-3)


def test_train_run_labels_match_jax_init_labels(run, corpus):
    jspace, _, _ = jharness.init_labels([corpus])
    assert run.labels == list(jspace.labels)
    meta = metadata.load_metadata(run.run_dir)
    assert meta["labels"] == meta["ebird_labels"] == list(jspace.labels)
    assert meta["remapped_labels"] == {
        l: int(jspace.remap[i]) for i, l in enumerate(jspace.source_labels)}


def test_train_run_writes_the_run_dir(run):
    d = run.run_dir
    for name in ("metadata.txt", "chkpt.pt", "val-loss.pt", "val-auc.pt",
                 "best.json", "history.json", "training-log.csv",
                 "weight-hists.jsonl", "confusion.npy", "confusion-none.npy",
                 "confusion-raw.npy", "epoch-confusion/epoch_000.npy"):
        assert (d / name).exists(), name
    hist = run.history
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
    assert np.isfinite(hist["val_loss"]).all()
    assert json.loads((d / "history.json").read_text()) == hist
    meta = metadata.load_metadata(d)
    assert meta["history"]["loss"] == hist["loss"]
    assert meta["test_samples"] == SPLITS["test"]
    assert meta["featurizer"] == config_to_dict(FeaturizerConfig(**GEOMETRY))
    cm = np.load(d / "confusion.npy")
    assert cm.shape == (len(run.labels) + 1,) * 2
    hists = [json.loads(l) for l in
             (d / "weight-hists.jsonl").read_text().splitlines()]
    assert [h["epoch"] for h in hists] == [0]
    assert len(hists[0]["mag.a_power"]) == 1
    assert set(hists[0]["convs.0.bias"]) == {"counts", "edges", "mean", "std"}
    (events,) = d.glob("events.out.tfevents.*")
    scalars = [e for e in read_events(events) if "scalars" in e]
    assert scalars[0]["step"] == 0
    assert scalars[0]["scalars"]["loss"] == pytest.approx(hist["loss"][0])
    assert "weights/mag.a_power" in scalars[1]["scalars"]


def test_bn_reestimation_is_saved_in_chkpt(run):
    """chkpt.pt holds the re-estimated statistics; the per-epoch copy of
    the same weights (val-loss.pt) holds the EMA's."""
    from audio_training_tpu_torch.train import load_state_dict

    final = load_state_dict(run.run_dir / "chkpt.pt")
    best = load_state_dict(run.run_dir / "val-loss.pt")
    assert torch.equal(final["convs.0.weight"], best["convs.0.weight"])
    assert not torch.equal(final["bns.0.running_mean"],
                           best["bns.0.running_mean"])


def test_load_predictor_loads_the_run(run):
    predictor, meta = predict.load_predictor(run.run_dir, "chkpt",
                                             device="cpu")
    assert predictor.labels == run.labels
    rng = np.random.default_rng(1)
    sr = GEOMETRY["sr"]
    t = np.arange(8 * sr) / sr
    rec = 0.01 * rng.standard_normal(t.size)
    rec[sr:4 * sr] += np.sin(2 * np.pi * FREQS[0] * t[sr:4 * sr])
    tracks, _ = predictor.predict_recording(rec.astype(np.float32), sr)
    assert isinstance(tracks, list)


def test_save_metadata_matches_jax(tmp_path):
    kw = dict(
        loss_fn="weighted_bce", multi_label=False, use_generic_bird=False,
        lme=True, mean_sub=True,
        history={"loss": [np.float32(0.5), 0.25], "lr": [1e-3, 1e-3]},
        test_results={"test_f1": 0.5, "per_label": {"kiwi": {"support": 2}}},
        training_data_meta={"counts": {"train": {}}, "type": "audio"},
        extra={"remapped_labels": {"kiwi": 0}},
    )
    labels = ["bird", "kiwi"]
    metadata.save_metadata(tmp_path / "p", "badwinner2", labels,
                           FeaturizerConfig(**GEOMETRY), load_ontology(),
                           **kw)
    jmetadata.save_metadata(tmp_path / "j", "badwinner2", labels,
                            JFeaturizerConfig(**GEOMETRY), jload(), **kw)
    got = metadata.load_metadata(tmp_path / "p")
    want = jmetadata.load_metadata(tmp_path / "j")
    assert float(got.pop("training_date")) > 0
    want.pop("training_date")
    assert got == want
    assert (metadata.featurizer_from_metadata(got)
            == FeaturizerConfig(**GEOMETRY))


@pytest.mark.parametrize("argv", [
    ["run", "-d", "data"],
    ["run", "-d", "data", "--epochs", "3", "--batch-size", "8", "--weighting",
     "--multi-label", "false", "--loss", "focal", "--mels", "96",
     "--extra-datasets", "a", "b", "--cross", "--random-butter", "0.6"],
])
def test_parse_args_matches_jax(argv):
    got, want = vars(cli.parse_args(argv)), vars(jcli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("flags,item", [
    # the id it had beside the backbone transplant's case
    pytest.param(["--data-shards", "2"], "Data parallel",
                 id="flags1-Data parallel"),
])
def test_cli_exits_2_naming_the_item(flags, item, capsys, tmp_path, corpus,
                                     one_step_run):
    """Data parallel, once refused with exit 2 naming its ROADMAP.md item,
    trains: ``--data-shards 2 --device cpu`` starts two gloo ranks, and its
    one run directory's history is the single-device run's
    (:func:`assert_history_matches`).  (``--backbone-weights``, refused the
    same way until it was ported, is tests/test_torch_transplant.py's.)"""
    conf = tmp_path / "train.json"
    conf.write_text(json.dumps({"compute_dtype": "float32",
                                "bn_reestimate": True}))
    assert cli.main(["dp", "-d", str(corpus), "--checkpoint-dir",
                     str(tmp_path), "--batch-size", "4", "--lr", "0.001",
                     "--epochs", "1", "--steps-per-epoch", "1",
                     "--epoch-confusion", "-c", str(conf), "--device",
                     "cpu"] + flags) == 0
    assert [p.name for p in tmp_path.iterdir() if p.is_dir()] == ["dp"]
    hist = json.loads((tmp_path / "dp" / "history.json").read_text())
    assert_history_matches(hist, one_step_run.history)
    meta = metadata.load_metadata(tmp_path / "dp")
    assert meta["test_samples"] == SPLITS["test"]


def write_feature_corpus(root, cfg, seed=0):
    """The harness corpus' tones at 5 s (the dual views' hops of 278 and 280
    need about 110 frames for badwinner2's 1x9 head, as JAX
    tests/test_harness.py builds its dual corpus), each record also
    carrying short / mid features and a 1280-d embedding that tell its
    species apart (offset +2 / 0 / -2 over noise)."""
    from audio_training_tpu_torch.data import (
        EMBEDDING_DIM, MID_FEATURES_SHAPE, SHORT_FEATURES_SHAPE)

    rng = np.random.default_rng(seed)
    t = np.arange(cfg.samples_per_clip) / cfg.sr
    counts = {}
    for split, n in SPLITS.items():
        recs = []
        for i in range(n):
            k = i % len(SPECIES)
            raw = (0.05 * rng.standard_normal(t.size)
                   + 0.8 * np.sin(2 * np.pi * FREQS[k] * t))
            shift = 2.0 * (1 - k)
            recs.append(encode_sample(SampleRecord(
                raw=raw.astype(np.float32), tags=[SPECIES[k]],
                rec_id=f"{split}{i}", sr=cfg.sr,
                short_features=(0.1 * rng.standard_normal(
                    SHORT_FEATURES_SHAPE) + shift).astype(np.float32),
                mid_features=np.abs(rng.standard_normal(
                    MID_FEATURES_SHAPE) + shift).astype(np.float32),
                embeddings=(0.1 * rng.standard_normal(EMBEDDING_DIM)
                            + shift).astype(np.float32))))
        write_tfrecords(root / split / f"{split}-0.tfrecord", recs)
        per = {sp: len(range(j, n, len(SPECIES)))
               for j, sp in enumerate(SPECIES)}
        counts[split] = {"sample_counts": per, "rec_counts": per}
    meta = {"labels": SPECIES, "type": "audio", "counts": counts,
            **config_to_dict(cfg)}
    (root / "training-meta.json").write_text(json.dumps(meta, indent=4))
    return root


@pytest.fixture(scope="module")
def feature_corpus(tmp_path_factory):
    return write_feature_corpus(
        tmp_path_factory.mktemp("features"),
        FeaturizerConfig(**GEOMETRY, segment_length=5.0))


@pytest.mark.parametrize("name", ["embeddings", "merge", "cnn-features",
                                  "dual-badwinner2", "rf-features"])
def test_cli_trains_each_model_name(name, feature_corpus, tmp_path):
    """The run kinds beside the mel families train through ``cli.main`` at
    B=4, 1 epoch x 2 steps, f32: exit 0, the run dir's metadata and model
    file, a finite history (the forest's accuracies)."""
    conf = tmp_path / "train.json"
    conf.write_text(json.dumps({"compute_dtype": "float32"}))
    assert cli.main(["run", "-d", str(feature_corpus), "--checkpoint-dir",
                     str(tmp_path), "--model-name", name, "--batch-size",
                     "4", "--epochs", "1", "--steps-per-epoch", "2", "-c",
                     str(conf), "--device", "cpu"]) == 0
    d = tmp_path / "run"
    meta = metadata.load_metadata(d)
    assert meta["name"] == name
    if name == "rf-features":
        assert (d / "random_forest.pkl").exists()
        acc = meta["rf_history"]
        assert acc["train_accuracy"][0] == 1.0
        assert 0.0 <= acc["val_accuracy"][0] <= 1.0
        return
    assert (d / "chkpt.pt").exists()
    hist = json.loads((d / "history.json").read_text())
    assert len(hist["loss"]) == 1
    assert np.isfinite(hist["loss"]).all()
    assert np.isfinite(hist["val_loss"]).all()
    if name == "merge":
        assert meta["test_samples"] == SPLITS["test"]
        assert (d / "confusion.npy").exists()


def test_train_run_refuses_unported_configs(corpus, tmp_path, one_step_run):
    """``num_data_shards=2``, once refused, trains on two gloo ranks: every
    rank returns the single-device run's history (as
    :func:`assert_history_matches` holds it) and the same test metrics, and
    the run directory holds every artifact."""
    from audio_training_tpu_torch.parallel.multihost import run_ranks

    import torch_dp_ranks

    results = run_ranks(torch_dp_ranks.train_run_rank, 2, args=(
        [corpus], tmp_path, dict(TRAIN, num_data_shards=2),
        dict(featurizer=FeaturizerConfig(**GEOMETRY), steps_per_epoch=1)),
        timeout_s=120.0)
    for r in results:
        assert r["labels"] == one_step_run.labels
        assert_history_matches(r["history"], one_step_run.history)
        assert r["test_metrics"]["test_samples"] == SPLITS["test"]
    assert results[0]["test_metrics"] == results[1]["test_metrics"]
    for name in ("chkpt.pt", "history.json", "confusion.npy",
                 "epoch-confusion/epoch_000.npy", "metadata.txt"):
        assert name in results[0]["files"], name


def test_cli_trains_from_the_corpus(corpus, tmp_path):
    """``main`` reads the featurizer from training-meta.json and trains."""
    conf = tmp_path / "train.json"
    conf.write_text(json.dumps({"compute_dtype": "float32"}))
    assert cli.main(["cli", "-d", str(corpus), "--checkpoint-dir",
                     str(tmp_path), "--batch-size", "4", "--epochs", "1",
                     "--steps-per-epoch", "1", "-c", str(conf),
                     "--device", "cpu"]) == 0
    meta = metadata.load_metadata(tmp_path / "cli")
    assert meta["featurizer"] == config_to_dict(FeaturizerConfig(**GEOMETRY))
    assert (tmp_path / "cli" / "chkpt.pt").exists()


def test_kfold_indices_match_jax():
    for n, folds in ((10, 5), (7, 3)):
        got = harness.kfold_indices(n, folds, np.random.default_rng(3))
        want = jharness.kfold_indices(n, folds, np.random.default_rng(3))
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_cross_fold_train_splits_files(corpus, tmp_path):
    results = harness.cross_fold_train(
        [corpus], "cv", folds=2, checkpoint_root=tmp_path,
        train_cfg=TrainConfig(**{**TRAIN, "bn_reestimate": False,
                                 "epoch_confusion": False}),
        featurizer=FeaturizerConfig(**GEOMETRY), steps_per_epoch=1,
        device="cpu")
    assert len(results) == 2
    for r in results:
        files = json.loads((r.run_dir / "fold-files.json").read_text())
        assert not set(files["train"]) & set(files["validation"])
        assert not set(files["test"]) & set(files["train"])
        assert np.isfinite(r.history["loss"]).all()
