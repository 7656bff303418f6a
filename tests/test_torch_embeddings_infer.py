"""The port's embedding-model inference (``infer/embeddings.py``), the
``embeddings`` route and speech scorer of ``cli/predict`` and the Perch
embedder of the build (``corpus/writer``, ``cli/build --embedding-model``)
against the JAX package's, on the CPU.

Without TensorFlow, one numpy stand-in embedder goes to both packages
(``chip_smoke.StandInPerch``: 32 kHz, 5 s windows, 1280-d; and a YAMNet
stand-in here), with a ``LinearEmbeddings`` head of the same seeded Flax
variables: ``predict_recording`` / ``predict_windows`` give equal tracks
and probabilities within 1e-5, the empty-window case included, and
``process_recording`` writes JAX's records bitwise.  The refusals (no
model, no TensorFlow) are JAX's.

With TensorFlow (``tests.conftest.requires_tf``), the fake Perch and
YAMNet saved models of tests/test_embeddings_infer.py (their real call
signatures): the wrappers' outputs bitwise JAX's, ``cli/predict
--embedding-model`` (and ``--yamnet-model``) on an ``embeddings`` run
predicting JAX's tracks and speech score, ``cli/build --embedding-model``
writing JAX's records (decompressed, bitwise).
"""

import json
import sys

import numpy as np
import pytest
import torch

from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.config import InferenceConfig as JaxInferenceConfig
from audio_training_tpu.infer import embeddings as jembeddings
from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu_torch.config import FeaturizerConfig, InferenceConfig
from audio_training_tpu_torch.data._native import split_records
from audio_training_tpu_torch.infer import embeddings
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import state_dict_from_flax

from chip_smoke import StandInPerch, synthetic_recording
from tests.conftest import requires_tf
from test_torch_cli_predict import _assert_tracks_match
from test_torch_corpus import (  # noqa: F401 (raw_dirs is a fixture)
    BUILD_GEOMETRY,
    NO_RMS,
    assert_records_equal,
    both,
    cfgs,
    mod,
    raw_dirs,
    shard_streams,
)

torch.set_num_threads(2)

LABELS = [f"l{i}" for i in range(5)]
PERCH_SAMPLES = 5 * 32000
PROB_TOL = 1e-5


class StandInYamnet:
    """A numpy YAMNet stand-in: 16 kHz audio -> one 1024-d embedding and
    521 scores a half second (no ``WINDOW_S``: the build embeds each
    window alone)."""

    name = "yamnet"
    sample_rate = 16000
    available = True

    def embed(self, frames):
        n = max(len(frames) // 8000, 1)
        pieces = np.resize(frames.astype(np.float64), (n, 8000))
        rms = np.sqrt((pieces**2).mean(-1, keepdims=True))
        emb = (rms * np.linspace(0.5, 1.5, 1024)).astype(np.float32)
        scores = np.tile(np.tanh(rms), (1, 521)).astype(np.float32)
        return emb, scores

    def embed_window(self, window):
        emb, _ = self.embed(window)
        return emb.mean(axis=0)

    def speech_score(self, frames, speech_index=0):
        return float(np.max(self.embed(frames)[1][:, speech_index]))


def head_variables(seed=0, num_labels=len(LABELS)):
    rng = np.random.default_rng(seed)
    return {"params": {"Dense_0": {
        "kernel": rng.normal(0.0, 0.05, (1280, num_labels)).astype(
            np.float32),
        "bias": rng.normal(0.0, 0.1, num_labels).astype(np.float32)}}}


def port_head(variables):
    module = build_model("embeddings", len(LABELS), logits_only=True).module
    module.load_state_dict(state_dict_from_flax(module, variables))
    return module


def predictors(embedder, multi_label=True, threshold=0.0):
    """(JAX, port) EmbeddingPredictors over ``embedder`` that keep each
    batch's probabilities in ``.seen``."""
    variables = head_variables()

    class JaxRecorded(jembeddings.EmbeddingPredictor):
        def _probs(self, embs):
            out = super()._probs(embs)
            self.seen.append(out)
            return out

    class Recorded(embeddings.EmbeddingPredictor):
        def _probs(self, embs):
            out = super()._probs(embs)
            self.seen.append(out)
            return out

    jmod = jax_build_model("embeddings", len(LABELS), logits_only=True).module
    jax_pred = JaxRecorded(embedder, jmod, variables, LABELS, JaxConfig(),
                           JaxInferenceConfig(threshold=threshold),
                           multi_label=multi_label)
    pred = Recorded(embedder, port_head(variables), LABELS,
                    FeaturizerConfig(), InferenceConfig(threshold=threshold),
                    multi_label=multi_label, device="cpu")
    jax_pred.seen, pred.seen = [], []
    return jax_pred, pred


def _metas(tracks):
    return [t.get_meta() for t in tracks]


@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("detect", [True, False])
def test_predict_recording_matches_jax(multi_label, detect):
    """Tracks detected (or given) and aggregated as in JAX; each window's
    probabilities within 1e-5 (sigmoid or softmax by ``multi_label``)."""
    from audio_training_tpu.detect.signals import Signal as JaxSignal
    from audio_training_tpu_torch.detect.signals import Signal

    sr = 8000  # not the model's rate: the recording is resampled
    frames = synthetic_recording(14.0, sr, 3)
    jax_pred, pred = predictors(StandInPerch(), multi_label)
    given = {}
    if not detect:
        given = {"jax": [JaxSignal(2.0, 7.0, 500, 3000, 1)],
                 "port": [Signal(2.0, 7.0, 500, 3000, 1)]}
    want, _ = jax_pred.predict_recording(frames, sr, tracks=given.get("jax"))
    got, _ = pred.predict_recording(frames, sr, tracks=given.get("port"))
    assert len(got) >= 1
    _assert_tracks_match(_metas(got), _metas(want))
    assert all(m["predictions"][0]["model"] == "embeddings-perch"
               for m in _metas(got))
    p, q = np.concatenate(pred.seen), np.concatenate(jax_pred.seen)
    assert p.dtype == np.float32 and p.shape == q.shape and len(p) >= 3
    assert np.abs(p - q).max() < PROB_TOL
    if not multi_label:
        np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("sr", [None, 32000, 16000])
def test_predict_windows_matches_jax(sr):
    """``predict_windows`` (the folder evaluators' call) resamples each
    window to the model's rate (the featurizer's rate by default)."""
    jax_pred, pred = predictors(StandInPerch())
    rng = np.random.default_rng(4)
    n = 3 * (sr or FeaturizerConfig().sr)
    windows = rng.standard_normal((3, n)).astype(np.float32)
    got, want = pred.predict_windows(windows, sr), jax_pred.predict_windows(
        windows, sr)
    assert got.shape == want.shape == (3, len(LABELS))
    assert np.abs(got - want).max() < PROB_TOL


def test_empty_windows_and_tracks_match_jax():
    """No windows: (0, labels) probabilities; a recording without tracks:
    no result and no classifier call, as in JAX."""
    jax_pred, pred = predictors(StandInPerch())
    empty = np.zeros((0, 10), np.float32)
    got, want = pred.predict_windows(empty), jax_pred.predict_windows(empty)
    assert got.shape == want.shape == (0, len(LABELS))
    assert got.dtype == want.dtype
    frames = synthetic_recording(4.0, 8000, 5)
    assert (pred.predict_recording(frames, 8000, tracks=[])
            == jax_pred.predict_recording(frames, 8000, tracks=[])
            == ([], []))
    assert not pred.seen and not jax_pred.seen


def test_head_runs_on_the_named_device():
    """The head sits on ``device`` (the card unless told otherwise; a CUDA
    device without a card raises), in eval mode."""
    _, pred = predictors(StandInPerch())
    assert pred.device == torch.device("cpu")
    assert not pred.module.training
    assert next(pred.module.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            embeddings.EmbeddingPredictor(
                StandInPerch(), port_head(head_variables()), LABELS,
                FeaturizerConfig())


def test_wrappers_without_a_model_match_jax(tmp_path):
    """No path, a missing path: not available, and ``embed`` raises JAX's
    RuntimeError; TensorFlow is not imported for them."""
    for path in (None, tmp_path / "missing"):
        for cls in ("PerchModel", "YamnetModel"):
            got, want = (getattr(embeddings, cls)(path),
                         getattr(jembeddings, cls)(path))
            assert not got.available and not want.available
            assert (got.name, got.sample_rate) == (want.name,
                                                   want.sample_rate)
            with pytest.raises(RuntimeError) as g:
                got.embed(np.zeros(PERCH_SAMPLES, np.float32))
            with pytest.raises(RuntimeError) as w:
                want.embed(np.zeros(PERCH_SAMPLES, np.float32))
            assert str(g.value) == str(w.value)
    assert embeddings.PERCH_EMBEDDING_DIM == jembeddings.PERCH_EMBEDDING_DIM
    assert (embeddings.YAMNET_EMBEDDING_SHAPE
            == jembeddings.YAMNET_EMBEDDING_SHAPE)


def test_model_without_tensorflow_is_not_available(tmp_path, monkeypatch):
    """An existing path on a machine without TensorFlow: both wrappers log
    the failure and are not available."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    assert not embeddings.PerchModel(tmp_path).available
    assert not jembeddings.PerchModel(tmp_path).available


@pytest.mark.parametrize("embedder", ["perch", "yamnet"])
def test_process_recording_embeddings_match_jax(raw_dirs, embedder):
    """The build's embedder path with one stand-in for both packages: one
    batched call a recording (Perch, 5 s windows) or one a window (an
    embedder without ``WINDOW_S``); records bytes equal."""
    stand_in = StandInPerch() if embedder == "perch" else StandInYamnet()

    def run(pkg):
        cfg, sampling = cfgs(pkg, tighten_tracks=False, filter_rms=False)
        rec = mod(pkg, "corpus").Recording(
            json.loads((raw_dirs / "raw" / "rec1.txt").read_text()),
            raw_dirs / "raw" / "rec1.wav", sampling)
        return mod(pkg, "corpus.writer").process_recording(
            rec, cfg, embedder=stand_in)

    want, got = both(run)
    assert got
    assert_records_equal(got, want)
    from audio_training_tpu_torch.data.schema import decode_sample

    sample = decode_sample(got[0], want_embeddings=True)
    dim = 1280 if embedder == "perch" else 1024
    assert sample.embeddings.ravel().shape == (dim,)


def _build(pkg, raw, out, flags):
    argv = [str(out), "-d", str(raw), *BUILD_GEOMETRY, *NO_RMS,
            "--workers", "1", *flags]
    assert mod(pkg, "cli.build").main(argv) == 0
    return out / "training-data"


def _assert_builds_equal(want, got):
    assert ((got / "training-meta.json").read_bytes()
            == (want / "training-meta.json").read_bytes())
    got_s, want_s = shard_streams(got), shard_streams(want)
    assert got_s.keys() == want_s.keys() and got_s
    for name in got_s:
        assert_records_equal(list(map(bytes, split_records(got_s[name]))),
                             list(map(bytes, split_records(want_s[name]))))


def test_build_with_an_unloadable_embedding_model_matches_jax(raw_dirs,
                                                               tmp_path):
    """``cli/build --embedding-model`` with a path that does not load: both
    packages log it and write their records without embeddings; the
    parser takes the flag as JAX's does."""
    from audio_training_tpu.cli.build import parse_args as jax_parse_args
    from audio_training_tpu_torch.cli import build

    flags = ["--embedding-model", str(tmp_path / "missing")]
    argv = [str(tmp_path / "out"), "-d", str(raw_dirs / "raw"), *flags]
    assert vars(build.parse_args(argv)) == vars(jax_parse_args(argv))
    want, got = both(lambda pkg: _build(pkg, raw_dirs / "raw",
                                        tmp_path / pkg, flags))
    _assert_builds_equal(want, got)


def embeddings_run(root, variables):
    """An ``embeddings`` run dir holding both packages' weights: the port's
    ``val-loss.pt`` and JAX's orbax ``val-loss/`` of the same variables."""
    import orbax.checkpoint as ocp

    from audio_training_tpu_torch.taxonomy.ontology import load_ontology
    from audio_training_tpu_torch.train.checkpoints import save_state_dict
    from audio_training_tpu_torch.train.metadata import save_metadata

    run = root / "run"
    save_metadata(run, "embeddings", LABELS, FeaturizerConfig(),
                  load_ontology())
    save_state_dict(run / "val-loss.pt", port_head(variables).state_dict())
    save_orbax(run / "val-loss", variables)
    return run


def save_orbax(path, variables):
    """JAX's checkpoint of ``variables`` (what its ``load_predictor``
    reads)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path.resolve(), {"params": variables["params"],
                                "batch_stats": variables.get(
                                    "batch_stats", {}),
                                "step": np.asarray(0)})
    ckptr.wait_until_finished()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return embeddings_run(tmp_path_factory.mktemp("emb"), head_variables())


@pytest.mark.parametrize("kind", ["perch", "yamnet"])
def test_load_predictor_needs_the_embedding_model_as_jax(run, tmp_path, kind):
    """An ``embeddings`` run without a loadable ``--embedding-model`` fails
    in ``load_predictor`` with JAX's RuntimeError."""
    from audio_training_tpu.cli.predict import load_predictor as jax_load
    from audio_training_tpu_torch.cli import predict

    for model in (None, str(tmp_path / "missing")):
        with pytest.raises(RuntimeError) as want:
            jax_load(run, "val-loss", embedding_model=model,
                     embedding_kind=kind)
        with pytest.raises(RuntimeError) as got:
            predict.load_predictor(run, "val-loss", embedding_model=model,
                                   embedding_kind=kind, device="cpu")
        assert str(got.value) == str(want.value)
        assert "--embedding-model" in str(got.value) and kind in str(
            got.value)


def test_unloadable_yamnet_model_exits_1_as_jax(tmp_path):
    """``--yamnet-model`` that does not load: exit 1 in both CLIs, after
    loading the run and before any prediction (a badwinner2 run holding
    both packages' weights)."""
    from audio_training_tpu.cli import predict as jax_predict
    from audio_training_tpu_torch.cli import predict
    from audio_training_tpu_torch.models.convert import (
        badwinner2_state_dict_from_flax,
    )
    from audio_training_tpu_torch.train.checkpoints import save_state_dict

    from test_torch_badwinner2 import flax_variables

    cfg = dict(sr=8000, n_fft=512, hop_length=100, n_mels=96, fmax=3500.0)
    jcfg = JaxConfig(**cfg)
    _, v = flax_variables((1, jcfg.n_mels, jcfg.mel_frames, 1),
                          num_labels=len(LABELS))
    run_dir = tmp_path / "run"
    save_state_dict(run_dir / "val-loss.pt",
                    badwinner2_state_dict_from_flax(v))
    save_orbax(run_dir / "val-loss", v)
    (run_dir / "metadata.txt").write_text(json.dumps({
        "name": "badwinner2", "labels": LABELS, "ebird_labels": LABELS,
        "multi_label": True, "channels": 1, "featurizer": cfg}))
    argv = [str(run_dir), "--file", str(tmp_path / "x.wav"),
            "--yamnet-model", str(tmp_path / "missing")]
    assert jax_predict.main(argv) == 1
    assert predict.main(argv + ["--device", "cpu"]) == 1


# ---------------------------------------------------------------------------
# With TensorFlow: fake Perch / YAMNet saved models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tf():
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    return tf


@pytest.fixture(scope="module")
def perch_path(tf, tmp_path_factory):
    class FakePerch(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([None, PERCH_SAMPLES], tf.float32)
        ])
        def infer_tf(self, x):
            mean = tf.reduce_mean(x, axis=1, keepdims=True)
            ramp = tf.range(1280, dtype=tf.float32)[None, :] / 1280.0
            emb = mean + ramp * tf.math.reduce_std(x, axis=1, keepdims=True)
            label = tf.tile(mean, [1, 10])
            return {"embedding": emb, "label": label}

    path = tmp_path_factory.mktemp("perch") / "model"
    tf.saved_model.save(FakePerch(), str(path))
    return path


@pytest.fixture(scope="module")
def yamnet_path(tf, tmp_path_factory):
    class FakeYamnet(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([None], tf.float32)])
        def __call__(self, wav):
            n = tf.maximum(tf.size(wav) // 8000, 1)
            col0 = 0.25 * tf.ones([n, 1]) + tf.reduce_max(tf.abs(wav)) / 8.0
            rest = 0.1 * tf.ones([n, 520])
            scores = tf.concat([col0, rest], axis=1)
            emb = tf.ones([n, 1024]) * tf.reduce_mean(wav)
            spect = tf.zeros([n, 64])
            return scores, emb, spect

    path = tmp_path_factory.mktemp("yamnet") / "model"
    tf.saved_model.save(FakeYamnet(), str(path))
    return path


@requires_tf
def test_saved_model_wrappers_match_jax_bitwise(perch_path, yamnet_path):
    """``embed`` / ``embed_window`` / ``speech_score`` of the port's
    wrappers over the fake saved models: bitwise JAX's."""
    rng = np.random.default_rng(6)
    frames = rng.standard_normal(2 * PERCH_SAMPLES + 5).astype(np.float32)
    perch, jperch = (embeddings.PerchModel(perch_path),
                     jembeddings.PerchModel(perch_path))
    assert perch.available and jperch.available
    for got, want in zip(perch.embed(frames), jperch.embed(frames)):
        assert got.shape[0] == 2
        np.testing.assert_array_equal(got, want)
    short = frames[: 3 * 32000]
    np.testing.assert_array_equal(perch.embed_window(short),
                                  jperch.embed_window(short))
    yam, jyam = (embeddings.YamnetModel(yamnet_path),
                 jembeddings.YamnetModel(yamnet_path))
    wav = frames[: 16000 * 4]
    for got, want in zip(yam.embed(wav), jyam.embed(wav)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(yam.embed_window(wav),
                                  jyam.embed_window(wav))
    assert yam.speech_score(wav) == jyam.speech_score(wav)


@requires_tf
def test_predict_cli_embedding_route_matches_jax(run, perch_path,
                                                 yamnet_path, tmp_path):
    """``cli/predict --embedding-model`` on an ``embeddings`` run (and
    ``--yamnet-model`` for the speech score): the port's JSON holds JAX's
    tracks, labels and confidences (within 1) and its speech score."""
    from scipy.io import wavfile

    from audio_training_tpu.cli import predict as jax_predict
    from audio_training_tpu_torch.cli import predict

    wav = tmp_path / "rec.wav"
    wavfile.write(wav, 48000, synthetic_recording(12.0, 48000, 7))
    outs = {}
    for name, main, extra in (("jax", jax_predict.main, []),
                              ("port", predict.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        assert main([str(run), "--file", str(wav), "--embedding-model",
                     str(perch_path), "--yamnet-model", str(yamnet_path),
                     "--threshold", "0.0", "--json-out", str(out),
                     *extra]) == 0
        outs[name] = json.loads(out.read_text())[str(wav)]
    got, want = outs["port"], outs["jax"]
    assert got["speech_score"] == want["speech_score"]
    _assert_tracks_match(got["tracks"], want["tracks"])
    pred, _ = predict.load_predictor(run, "val-loss", embedding_model=str(
        perch_path), device="cpu")
    assert isinstance(pred, embeddings.EmbeddingPredictor)
    assert pred.labels == LABELS and pred.model_name == "embeddings-perch"


@requires_tf
def test_build_with_perch_matches_jax(raw_dirs, perch_path, tmp_path):
    """``cli/build --embedding-model`` with the fake Perch: records with a
    1280-d embedding each, decompressed bytes equal to JAX's."""
    flags = ["--embedding-model", str(perch_path)]
    want, got = both(lambda pkg: _build(pkg, raw_dirs / "raw",
                                        tmp_path / pkg, flags))
    _assert_builds_equal(want, got)
    from audio_training_tpu_torch.data import find_shards, read_tfrecords
    from audio_training_tpu_torch.data.schema import decode_sample

    record = next(iter(read_tfrecords(find_shards(got, "train")[0])))
    sample = decode_sample(record, want_embeddings=True)
    assert sample.embeddings.ravel().shape == (1280,)
