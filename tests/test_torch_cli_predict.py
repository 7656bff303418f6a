"""``python -m audio_training_tpu_torch.cli.predict`` against the JAX CLI's
``predict_file``, end to end on the CPU.

A run directory holds ``metadata.txt`` and the port's weights file, written
from converted badwinner2 weights; the JAX side runs its Predictor on the
same Flax variables.  Both read the same WAV (the small 8 kHz, n_fft=512
geometry of tests/test_infer.py::test_predictor_end_to_end, so the JAX
Predictor runs K2 in interpret mode).  Tracks must match exactly; labels
and tags exactly; confidences, rounded percentages of probabilities that
agree to 1e-4, to within 1.  Each flag of the JAX CLI that the port leaves
out must exit 2 with its reason.  ``--test-split`` (``predict_on_test``)
gives JAX's confusion on a pinned test split.  A MobileNetV2 run
(PCEN frontend, 3 channels) loads through both packages' ``load_predictor``
(the JAX side from an orbax checkpoint of the same Flax variables) and its
per-track mean probabilities agree to 1e-4 of max |p|, the f32 tolerance of
tests/test_torch_backbones.py.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio_training_tpu.cli.predict import load_predictor as jax_load_predictor
from audio_training_tpu.cli.predict import predict_file as jax_predict_file
from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.config import InferenceConfig as JaxInferenceConfig
from audio_training_tpu.infer import Predictor as JaxPredictor
from audio_training_tpu_torch.cli import predict
from audio_training_tpu_torch.infer.windows import extract_track_windows
from audio_training_tpu_torch.models.convert import (
    backbone_classifier_state_dict_from_flax,
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.train.checkpoints import (
    load_state_dict,
    save_state_dict,
)

from test_torch_backbones import flax_classifier
from test_torch_badwinner2 import flax_variables
from test_torch_corpus import fixed_randomness

torch.set_num_threads(2)

SR = 8000
CFG = dict(sr=SR, n_fft=512, hop_length=100, n_mels=96, fmax=3500.0)
LABELS = ["kiwi", "morepo2", "noise", "tui", "bellbird", "human", "other"]


def _recording(seed, freq):
    t = np.arange(SR * 8) / SR
    x = (np.sin(2 * np.pi * freq * t) * (t % 4 < 1.2)).astype(np.float32)
    return x + 0.01 * np.random.default_rng(seed).standard_normal(
        len(x)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, JAX module, Flax variables, two WAV paths)."""
    root = tmp_path_factory.mktemp("cli")
    jcfg = JaxConfig(**CFG)
    module, v = flax_variables((1, jcfg.n_mels, jcfg.mel_frames, 1),
                               num_labels=len(LABELS))
    run_dir = root / "run"
    save_state_dict(run_dir / "val-loss.pt", badwinner2_state_dict_from_flax(v))
    meta = {"name": "badwinner2", "labels": LABELS, "ebird_labels": LABELS,
            "multi_label": True, "channels": 1, "featurizer": CFG,
            "mean_sub": False, "db_scale": False}
    (run_dir / "metadata.txt").write_text(json.dumps(meta))
    wavs = root / "wavs"
    wavs.mkdir()
    paths = []
    for i, freq in enumerate((1500, 2200)):
        path = wavs / f"rec{i}.wav"
        wavfile.write(path, SR, _recording(i, freq))
        paths.append(path)
    (wavs / "notes.txt").write_text("not audio")
    return run_dir, module, v, paths


def _jax_tracks(run, path, threshold, aggregation="mean"):
    _, module, v, _ = run
    pred = JaxPredictor(module, v, LABELS, JaxConfig(**CFG),
                        JaxInferenceConfig(threshold=0.7,
                                           aggregation=aggregation))
    tracks, _ = jax_predict_file(pred, path, threshold=threshold)
    return tracks


def _assert_tracks_match(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for key in ("start", "end", "freq_start", "freq_end", "positions"):
            assert g[key] == w[key]
        assert len(g["predictions"]) == len(w["predictions"]) == 1
        gp, wp = g["predictions"][0], w["predictions"][0]
        assert gp["labels"] == wp["labels"]
        assert gp.get("raw_tag") == wp.get("raw_tag")
        confs = zip(gp["confidences"] + [gp.get("raw_confidence", 0)],
                    wp["confidences"] + [wp.get("raw_confidence", 0)])
        assert all(abs(a - b) <= 1 for a, b in confs)


@pytest.mark.parametrize("aggregation", ["mean", "votes"])
def test_file_matches_jax_predict_file(run, tmp_path, aggregation):
    run_dir, _, _, paths = run
    out = tmp_path / "out.json"
    assert predict.main([str(run_dir), "--file", str(paths[0]),
                         "--threshold", "0.5", "--aggregation", aggregation,
                         "--json-out", str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert list(got) == [str(paths[0])]
    _assert_tracks_match(got[str(paths[0])],
                         _jax_tracks(run, paths[0], 0.5, aggregation))


def test_dir_with_thresholds_json_matches_jax(run, tmp_path):
    run_dir, _, _, paths = run
    table = {"kiwi": 0.3, "noise": 0.45, "tui": 0.9}
    thresholds = tmp_path / "thr.json"
    thresholds.write_text(json.dumps(table))
    out = tmp_path / "out.json"
    assert predict.main([str(run_dir), "--dir", str(paths[0].parent),
                         "--thresholds-json", str(thresholds),
                         "--json-out", str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert list(got) == [str(p) for p in paths]  # the .txt is skipped
    vector = np.array([table.get(l, 0.7) for l in LABELS], np.float32)
    for path in paths:
        _assert_tracks_match(got[str(path)], _jax_tracks(run, path, vector))


@pytest.fixture(scope="module")
def test_split(run, tmp_path_factory):
    """(raw corpus dir, pinned split file, JAX ``predict_on_test``'s
    confusion and labels): four 8 s recordings with sidecars, tagged kiwi,
    morepork (morepo2), tui (tui1, not among the run's labels) and kiwi,
    all in the test split; JAX's Predictor on the run's Flax variables,
    under the fixed randomness of tests/test_torch_corpus.py."""
    from audio_training_tpu.infer.folder import predict_on_test

    _, module, v, _ = run
    raw = tmp_path_factory.mktemp("test_split_raw")
    ids = []
    for i, (what, freq) in enumerate((("kiwi", 1500), ("morepork", 2200),
                                      ("tui", 900), ("kiwi", 1500))):
        ids.append(f"rec{i}")
        wavfile.write(raw / f"rec{i}.wav", SR, _recording(10 + i, freq))
        (raw / f"rec{i}.txt").write_text(json.dumps({
            "id": f"rec{i}", "duration": 8.0,
            "Tracks": [{"id": f"t{i}", "start": 0.5, "end": 6.5,
                        "tags": [{"what": what, "automatic": False}]}]}))
    split = raw.parent / "split.json"
    split.write_text(json.dumps({"recs": {"train": [], "validation": [],
                                          "test": ids}}))
    pred = JaxPredictor(module, v, LABELS, JaxConfig(**CFG),
                        JaxInferenceConfig())
    with fixed_randomness(0):
        cm, labels = predict_on_test(pred, split, raw)
    return raw, split, cm, labels


def test_predict_on_test_matches_jax(run, test_split):
    """``predict_on_test`` of the port against JAX's on the CPU, the
    weights carried across by ``models/convert``: equal confusions (argmax
    against the sample's label) and labels."""
    from audio_training_tpu_torch.infer.folder import predict_on_test

    raw, split, want_cm, want_labels = test_split
    pred, _ = predict.load_predictor(run[0], "val-loss", device="cpu")
    with fixed_randomness(0):
        cm, labels = predict_on_test(pred, split, raw)
    assert labels == want_labels == LABELS
    np.testing.assert_array_equal(cm, want_cm)
    assert cm.sum() >= 6  # every kiwi / morepo2 sample, no tui1 one


@pytest.mark.parametrize("case", ["no_data_dir", "default_out",
                                  "confusion_out"])
def test_test_split_flags(run, test_split, tmp_path, monkeypatch, case):
    """``--test-split`` without ``--data-dir`` fails as JAX's CLI does
    (``cli/predict.py:221``, exit 1); with it the confusion is written to
    ``--confusion-out`` (default ``./confusions/test-split``) and equals
    JAX's ``predict_on_test``."""
    raw, split, want_cm, _ = test_split
    monkeypatch.chdir(tmp_path)
    argv = [str(run[0]), "--test-split", str(split), "--device", "cpu"]
    if case == "no_data_dir":
        assert predict.main(argv) == 1
        assert not (tmp_path / "confusions").exists()
        return
    argv += ["--data-dir", str(raw)]
    out = tmp_path / "confusions" / "test-split.npy"
    if case == "confusion_out":
        out = tmp_path / "cm" / "split"
        argv += ["--confusion-out", str(out)]
        out = out.with_suffix(".npy")
    with fixed_randomness(0):
        assert predict.main(argv) == 0
    np.testing.assert_array_equal(np.load(out), want_cm)


@pytest.mark.parametrize("flags,reason", [
    (["--embedding-model", "m"], "TensorFlow saved model"),
    (["--embedding-kind", "yamnet"], "TensorFlow saved model"),
    (["--yamnet-model", "m"], "TensorFlow saved model"),
])
def test_unported_flags_exit_non_zero(run, capsys, flags, reason):
    """The JAX CLI's flags that the port leaves out exit 2 with their
    reason; the parser knows every JAX flag (none is unrecognized)."""
    with pytest.raises(SystemExit) as exc:
        predict.parse_args([str(run[0]), "--file", "x.wav", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flags[0] in err and reason in err
    assert "unrecognized" not in err


def test_parser_knows_every_jax_flag():
    from audio_training_tpu.cli.predict import parse_args as jax_parse_args

    jax_flags = set(vars(jax_parse_args(["m"])))
    port_flags = set(vars(predict.parse_args(["m"])))
    assert jax_flags <= port_flags and port_flags - jax_flags == {"device"}


def test_loader_reads_the_port_weights_only(run, tmp_path):
    run_dir, _, v, _ = run
    sd = load_state_dict(run_dir / "val-loss.pt")
    want = badwinner2_state_dict_from_flax(v)
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in sd)
    # the frozen-deployment name is found when the named file is absent
    frozen = tmp_path / "frozen"
    save_state_dict(frozen / "audioModel.pt", sd)
    (frozen / "metadata.txt").write_text((run_dir / "metadata.txt").read_text())
    pred, meta = predict.load_predictor(frozen, "val-loss", device="cpu")
    assert pred.labels == LABELS and meta["name"] == "badwinner2"
    assert pred.device == torch.device("cpu")
    # a JAX run dir holds an orbax checkpoint directory
    orbax = tmp_path / "orbax"
    (orbax / "val-loss").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="orbax"):
        predict.weights_path(orbax, "val-loss")
    with pytest.raises(FileNotFoundError, match="no val-loss.pt"):
        predict.weights_path(tmp_path, "val-loss")


@pytest.fixture(scope="module")
def mobilenet_run(run, tmp_path_factory):
    """A MobileNetV2 run dir in both packages' formats: the port's weights
    file and an orbax checkpoint of the same Flax variables."""
    import orbax.checkpoint as ocp

    jcfg = JaxConfig(**CFG)
    _, v = flax_classifier((1, jcfg.n_mels, jcfg.mel_frames, 3), "pcen",
                           num_labels=len(LABELS))
    run_dir = tmp_path_factory.mktemp("mobilenet")
    save_state_dict(run_dir / "val-loss.pt",
                    backbone_classifier_state_dict_from_flax(v))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((run_dir / "val-loss").resolve(),
               {"params": v["params"], "batch_stats": v["batch_stats"],
                "step": np.asarray(0)}, force=True)
    ckptr.wait_until_finished()
    meta = json.loads((run[0] / "metadata.txt").read_text())
    meta.update(name="mobilenet", channels=3)
    (run_dir / "metadata.txt").write_text(json.dumps(meta))
    return run_dir


def test_mobilenet_run_matches_jax_load_predictor(run, mobilenet_run,
                                                  tmp_path):
    """``load_predictor`` builds any registered model: a MobileNetV2 run's
    per-track mean probabilities match the JAX CLI's loader's."""
    paths = run[3]
    pred, meta = predict.load_predictor(mobilenet_run, "val-loss",
                                        device="cpu")
    jpred, jmeta = jax_load_predictor(mobilenet_run, "val-loss")
    assert meta["name"] == jmeta["name"] == "mobilenet"
    assert pred.channels == jpred.channels == 3
    frames = _recording(0, 1500)
    tracks, _ = pred.predict_recording(frames, SR, threshold=0.5)
    batch = extract_track_windows(
        frames, SR, tracks, segment_length=pred.cfg.segment_length,
        stride=pred.cfg.segment_stride, fmin=pred.cfg.fmin,
        fmax=pred.cfg.fmax)
    got, want = (p.predict_windows(batch.windows) for p in (pred, jpred))
    per_track = [np.flatnonzero(batch.track_index == i)
                 for i in range(len(tracks))]
    assert sum(len(i) for i in per_track) == len(batch.windows) >= 2
    got = np.stack([got[i].mean(0) for i in per_track])
    want = np.stack([want[i].mean(0) for i in per_track])
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # and the CLI runs the run end to end
    out = tmp_path / "out.json"
    assert predict.main([str(mobilenet_run), "--file", str(paths[0]),
                         "--json-out", str(out), "--device", "cpu"]) == 0
    assert len(json.loads(out.read_text())[str(paths[0])]) == len(tracks)


def test_needs_file_or_dir(run):
    assert predict.main([str(run[0]), "--device", "cpu"]) == 1
