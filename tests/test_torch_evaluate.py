"""Evaluation and deployment through the Predictor, the port against the
JAX package, end to end on the CPU.

One run directory serves both packages: the port's weights file and an
orbax checkpoint of the same Flax badwinner2 variables, with the small
8 kHz / n_fft 512 geometry of tests/test_torch_cli_predict.py (the JAX
Predictor runs K2 in interpret mode, the port K2's plain version).  Both
read the same WAVs and sidecars.  Strong, weak and folder evaluation give
equal confusion matrices and per-file results, with per-track
probabilities to 1e-4 of max |p| (the f32 tolerance of the Predictor
tests); ``cli/evaluate``, ``cli/freeze`` and ``cli/predict``'s ``--grid``,
``--denoise`` and ``--folder-eval`` write what the JAX CLIs write, and the
flags left out exit 2 (tests/test_torch_cli_predict.py).  The JAX cases
mirrored: tests/test_cli.py:169-480.
"""

import json
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio_training_tpu.cli import evaluate as jax_evaluate
from audio_training_tpu.cli import predict as jax_predict
from audio_training_tpu.eval.strong import evaluate_strong_dir as jax_strong
from audio_training_tpu.eval.weak import (
    evaluate_weakly_labelled_dir as jax_weak,
)
from audio_training_tpu.infer.ebirdgrid import apply_species_mask as jax_mask
from audio_training_tpu.infer.folder import predict_on_folder as jax_folder
from audio_training_tpu_torch.cli import evaluate, freeze, predict
from audio_training_tpu_torch.eval import save_raw_predictions
from audio_training_tpu_torch.eval.strong import evaluate_strong_dir
from audio_training_tpu_torch.eval.weak import evaluate_weakly_labelled_dir
from audio_training_tpu_torch.infer.folder import predict_on_folder
from audio_training_tpu_torch.models.convert import (
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.train.checkpoints import save_state_dict

from test_torch_badwinner2 import flax_variables
from test_torch_cli_predict import CFG, LABELS, SR, _assert_tracks_match

torch.set_num_threads(2)

PROB_TOL = 1e-4  # of max |p|
# sidecar tag -> tone frequency: "morepork" reads as morepo2, "tui" as tui1
# (not a model label: the bird fallback), "rain" as a noise label
TONES = {"kiwi": 1500, "morepork": 800, "tui": 2500, "rain": 3200}


def _recording(seed, freq, seconds=8.0):
    """Noise with 1.2 s tone bursts every 2 s: the detector finds each."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    x = np.sin(2 * np.pi * freq * t) * (t % 2.0 < 1.2) * (t > 0.4)
    return (x + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _write_dirs(root):
    strong, weak, folder = root / "strong", root / "weak", root / "folder"
    for i, (what, freq) in enumerate(TONES.items()):
        sub = strong / ("a" if i % 2 else "b")
        sub.mkdir(parents=True, exist_ok=True)
        wavfile.write(sub / f"{100 + i}-rec.wav", SR, _recording(i, freq))
        tracks = [{"id": 10 * i, "start": 0.4, "end": 5.6,
                   "tags": [{"what": what}]},
                  {"id": 10 * i + 1, "start": 6.0, "end": 7.2,
                   "tags": [{"what": "kiwi"}], "minFreq": 1000,
                   "maxFreq": 2000},
                  {"id": 10 * i + 2, "start": 1.0, "end": 3.0,
                   "tags": [{"what": "kiwi"}, {"what": "tui"}]}]
        (sub / f"{100 + i}-rec.txt").write_text(json.dumps(
            {"id": 100 + i, "duration": 8.0, "Tracks": tracks}))
        label = {"morepork": "morepo2"}.get(what, what)
        (weak / label).mkdir(parents=True, exist_ok=True)
        wavfile.write(weak / label / f"w{i}.wav", SR, _recording(20 + i, freq))
        folder.mkdir(exist_ok=True)
        wavfile.write(folder / f"f{i}.wav", SR, _recording(40 + i, freq))
        (folder / f"f{i}.txt").write_text(json.dumps({"id": i, "best_track": {
            "start": 0.3, "end": 6.5, "tags": [{"what": label}]}}))
    (strong / "b" / "orphan.txt").write_text("{}")  # no audio file
    (weak / "kiwi" / "notes.txt").write_text("not audio")
    (folder / "no-best.txt").write_text(json.dumps({"id": 9}))
    wavfile.write(folder / "no-best.wav", SR, _recording(9, 1000))
    return strong, weak, folder


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, port Predictor, JAX Predictor, strong / weak / folder
    dirs).  The run dir holds both packages' weights."""
    import orbax.checkpoint as ocp

    from audio_training_tpu.config import FeaturizerConfig as JaxConfig

    root = tmp_path_factory.mktemp("evaluate")
    jcfg = JaxConfig(**CFG)
    _, v = flax_variables((1, jcfg.n_mels, jcfg.mel_frames, 1),
                          num_labels=len(LABELS))
    run_dir = root / "run"
    save_state_dict(run_dir / "val-loss.pt", badwinner2_state_dict_from_flax(v))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((run_dir / "val-loss").resolve(),
               {"params": v["params"], "batch_stats": v["batch_stats"],
                "step": np.asarray(0)}, force=True)
    ckptr.wait_until_finished()
    meta = {"name": "badwinner2", "labels": LABELS, "ebird_labels": LABELS,
            "multi_label": True, "channels": 1, "featurizer": CFG,
            "remapped_labels": {"kiwi": 0, "morepo2": 1, "rain": 2}}
    (run_dir / "metadata.txt").write_text(json.dumps(meta))
    pred, _ = predict.load_predictor(run_dir, "val-loss", device="cpu")
    jpred, _ = jax_predict.load_predictor(run_dir, "val-loss")
    return (run_dir, pred, jpred) + _write_dirs(root)


def _raw_dump(prefix):
    with open(f"{prefix}-raw.npy", "rb") as f:
        ids, y_true, pred_mean, conf, labels = (np.load(f) for _ in range(5))
    with open(f"{prefix}-raw-confidences.pkl", "rb") as f:
        windows = pickle.load(f)
    return ids, y_true, pred_mean, conf, labels, windows


@pytest.mark.parametrize("threshold,rec_ids", [(0.5, None), (0.7, None),
                                               (0.5, [100, 103])])
def test_strong_dir_matches_jax(run, tmp_path, threshold, rec_ids):
    """evaluate_strong_dir: the label space, the three confusions and the
    track truths equal; per-track and per-window probabilities to 1e-4."""
    _, pred, jpred, strong, _, _ = run
    got = evaluate_strong_dir(pred, strong, tmp_path / "port" / "s",
                              threshold=threshold, rec_ids=rec_ids)
    want = jax_strong(jpred, strong, tmp_path / "jax" / "s",
                      threshold=threshold, rec_ids=rec_ids)
    assert got.labels == want.labels
    assert len(got.y_true) == (4 if rec_ids else 8)  # 2 tracks a recording
    assert (got.y_true, got.track_ids) == (want.y_true, want.track_ids)
    for a, b in ((got.mean_cm, want.mean_cm), (got.max_cm, want.max_cm),
                 (got.counts_cm, want.counts_cm)):
        np.testing.assert_array_equal(a, b)
    assert got.mean_cm.sum() == len(got.y_true)
    g, w = _raw_dump(tmp_path / "port" / "s"), _raw_dump(tmp_path / "jax" / "s")
    for a, b in zip(g[:3] + g[4:5], w[:3] + w[4:5]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(g[3] - w[3]).max() < PROB_TOL * np.abs(w[3]).max()
    win_g, win_w = np.concatenate(g[5]), np.concatenate(w[5])
    assert np.abs(win_g - win_w).max() < PROB_TOL * np.abs(win_w).max()
    for name in ("mean", "max", "counts"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / f"s-{name}.npy"),
            np.load(tmp_path / "jax" / f"s-{name}.npy"))


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_weak_dir_matches_jax(run, threshold):
    """evaluate_weakly_labelled_dir: host detection, per-file decisions and
    both confusions equal."""
    _, pred, jpred, _, weak, _ = run
    got = evaluate_weakly_labelled_dir(pred, weak, threshold=threshold,
                                       workers=1)
    want = jax_weak(jpred, weak, threshold=threshold, workers=1)
    assert got.labels == want.labels
    assert got.per_file == want.per_file
    # rain/ is skipped: not a model label
    assert len(got.per_file) == 3 and all(f["tracks"] for f in got.per_file)
    np.testing.assert_array_equal(got.mean_cm, want.mean_cm)
    np.testing.assert_array_equal(got.votes_cm, want.votes_cm)


def test_weak_dir_spawned_workers_match_inline(run, tmp_path):
    """Two spawned preprocessing workers give the inline result, and the
    confusions are written."""
    _, pred, _, _, weak, _ = run
    inline = evaluate_weakly_labelled_dir(pred, weak, workers=1)
    spawned = evaluate_weakly_labelled_dir(pred, weak, tmp_path / "w",
                                           workers=2)
    assert spawned.per_file == inline.per_file
    np.testing.assert_array_equal(spawned.mean_cm, inline.mean_cm)
    np.testing.assert_array_equal(np.load(tmp_path / "w-votes.npy"),
                                  inline.votes_cm)


@pytest.mark.parametrize("threshold", [0.5, None])
def test_folder_eval_matches_jax(run, threshold):
    """predict_on_folder: the annotated span of each best_track sidecar; the
    predicted labels equal, the label confidence (a rounded percentage of
    probabilities that agree to 1e-4) to within 1."""
    _, pred, jpred, _, _, folder = run
    got = predict_on_folder(pred, folder, threshold=threshold,
                            label_overrides={"tui": "kiwi"})
    want = jax_folder(jpred, folder, threshold=threshold,
                      label_overrides={"tui": "kiwi"})
    assert (got.total_files, got.total_correct) == (
        want.total_files, want.total_correct)
    assert got.total_files == 3  # rain is not a model label
    for g, w in zip(got.per_file, want.per_file):
        assert abs(g.pop("label_confidence") - w.pop("label_confidence")) <= 1
        assert g == w


def test_evaluate_cli_matches_jax(run, tmp_path):
    """``cli/evaluate`` strong, weak, mean, thresholds and compare: the
    files the JAX CLI writes, equal (thresholds from the port's curve)."""
    run_dir, _, _, strong, weak, _ = run
    out = {}
    for name, cli, extra in (("port", evaluate, ["--device", "cpu"]),
                             ("jax", jax_evaluate, [])):
        d = tmp_path / name
        assert cli.main(["strong", str(run_dir), str(strong), "--out",
                         str(d / "strong"), "--threshold", "0.5", *extra]) == 0
        assert cli.main(["weak", str(run_dir), str(weak), "--out",
                         str(d / "weak"), "--workers", "1", *extra]) == 0
        out[name] = d
    for f in ("strong-mean", "strong-max", "strong-counts", "weak-mean",
              "weak-votes"):
        np.testing.assert_array_equal(np.load(out["port"] / f"{f}.npy"),
                                      np.load(out["jax"] / f"{f}.npy"))
    # the two packages' per-track probabilities as two models' raw dumps
    dumps = []
    for name in ("port", "jax"):
        _, y_true, _, conf, labels, _ = _raw_dump(out[name] / "strong")
        model = list(labels[: conf.shape[1]])  # the eval space adds outputs
        onehot = np.eye(len(labels), dtype=np.float32)[y_true]
        dumps.append(save_raw_predictions(
            out[name] / "tracks", model, conf.astype(np.float32),
            onehot[:, : len(model)]))
    for name, cli in (("port", evaluate), ("jax", jax_evaluate)):
        assert cli.main(["mean", *map(str, dumps), "--threshold", "0.5",
                         "--out", str(out[name] / "ens")]) == 0
        assert cli.main(["thresholds", str(dumps[0]), "--out",
                         str(out[name] / "thr.json")]) == 0
        (out[name] / "metadata.txt").write_text(
            json.dumps({"ebird_labels": model}))
    np.testing.assert_array_equal(np.load(out["port"] / "ens.npy"),
                                  np.load(out["jax"] / "ens.npy"))
    assert (json.loads((out["port"] / "thr.json").read_text())
            == json.loads((out["jax"] / "thr.json").read_text()))
    first, second = (str(out[n] / "ens.npy") for n in out)
    assert evaluate.main(["compare", first, second]) == 0
    assert jax_evaluate.main(["compare", first, second]) == 0


def test_freeze_cli_deploys_the_run(run, tmp_path):
    """``cli/freeze``: the deployment's metadata equals the JAX CLI's
    (which copies the orbax checkpoint), and its Predictor gives the run's
    window probabilities bitwise."""
    from audio_training_tpu.cli import freeze as jax_freeze

    run_dir, pred, _, _, _, _ = run
    assert freeze.main([str(run_dir), str(tmp_path / "port")]) == 0
    assert jax_freeze.main([str(run_dir), str(tmp_path / "jax")]) == 0
    meta = json.loads((tmp_path / "port" / "metadata.txt").read_text())
    assert meta == json.loads((tmp_path / "jax" / "metadata.txt").read_text())
    assert meta["frozen"] and len(meta["ebird_ids"]) == len(LABELS)
    assert ((tmp_path / "port" / "audioModel.pt").read_bytes()
            == (run_dir / "val-loss.pt").read_bytes())
    deployed, _ = predict.load_predictor(tmp_path / "port", "audioModel",
                                         device="cpu")
    windows = np.stack([_recording(s, 1500)[: SR * 3] for s in range(3)])
    np.testing.assert_array_equal(deployed.predict_windows(windows),
                                  pred.predict_windows(windows))


def _grid(tmp_path):
    from audio_training_tpu.infer.ebirdgrid import build_species_grid

    csv = tmp_path / "obs.tsv"
    csv.write_text("\n".join([
        "COMMON NAME\tLATITUDE\tLONGITUDE\tOBSERVATION DATE",
        "Morepork\t-41.05\t174.05\t2024-06-15",
        "Tui\t-41.05\t174.15\t2024-01-10",
    ]))
    path = tmp_path / "grid.json"
    build_species_grid(csv, square_bounds=[[174.0, -41.1, 174.1, -41.0],
                                           [174.1, -41.1, 174.2, -41.0]],
                       out_path=path)
    return path


@pytest.mark.parametrize("month", [6, None])
def test_predict_cli_grid_matches_jax_mask(run, tmp_path, month):
    """``--grid --lat --lng --month`` at threshold 0 (every label listed):
    the tracks and labels of JAX's predict_file, masked as it masks them.
    The JAX CLI reads each track's meta before it applies the mask, so its
    own output keeps the masked-out labels (ROADMAP.md queue 3)."""
    run_dir, _, jpred, _, weak, _ = run
    grid = _grid(tmp_path)
    wav = weak / "kiwi" / "w0.wav"
    out = tmp_path / "out.json"
    argv = [str(run_dir), "--file", str(wav), "--threshold", "0",
            "--grid", str(grid), "--lat", "-41.05", "--lng", "174.05",
            "--json-out", str(out), "--device", "cpu"]
    if month:
        argv += ["--month", str(month)]
    assert predict.main(argv) == 0
    got = json.loads(out.read_text())[str(wav)]
    grid_meta = json.loads(grid.read_text())
    unmasked, _ = jax_predict.predict_file(jpred, wav, grid_meta, -41.05,
                                           174.05, month, threshold=0.0)
    want = json.loads(json.dumps(unmasked))
    for tm in want:
        for p in tm["predictions"]:
            probs = np.zeros(len(LABELS), np.float32)
            for label, c in zip(p["labels"], p["confidences"]):
                probs[LABELS.index(label)] = c / 100
            masked = jax_mask(probs, LABELS, grid_meta, -41.05, 174.05, month)
            kept = np.flatnonzero(masked > 0)
            p["labels"] = [LABELS[i] for i in kept]
            p["confidences"] = [round(float(masked[i]) * 100) for i in kept]
    _assert_tracks_match(got, want)
    assert all(len(p["labels"]) == len(LABELS) for tm in unmasked
               for p in tm["predictions"])
    seen = {"morepo2"} if month else {"morepo2", "tui1"}
    keep = seen | {"noise", "human", "other"}
    for tm in got:
        for p in tm["predictions"]:
            assert set(p["labels"]) <= keep and "kiwi" not in p["labels"]


def test_predict_cli_denoise_matches_jax(run, tmp_path):
    """``--denoise``: the spectral gate before detection, the tracks and
    labels of JAX's predict_file(denoise=True)."""
    run_dir, _, jpred, _, weak, _ = run
    wav = weak / "morepo2" / "w1.wav"
    out = tmp_path / "out.json"
    assert predict.main([str(run_dir), "--file", str(wav), "--denoise",
                         "--threshold", "0.5", "--json-out", str(out),
                         "--device", "cpu"]) == 0
    want, _ = jax_predict.predict_file(jpred, wav, threshold=0.5,
                                       denoise=True)
    _assert_tracks_match(json.loads(out.read_text())[str(wav)], want)


def test_predict_cli_folder_eval_matches_jax(run, tmp_path):
    run_dir, _, _, _, _, folder = run
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    argv = [str(run_dir), "--folder-eval", str(folder), "--threshold", "0.5"]
    assert predict.main(argv + ["--json-out", str(got), "--device",
                                "cpu"]) == 0
    assert jax_predict.main(argv + ["--json-out", str(want)]) == 0
    got, want = json.loads(got.read_text()), json.loads(want.read_text())
    for g, w in zip(got.pop("per_file"), want.pop("per_file")):
        assert abs(g.pop("label_confidence") - w.pop("label_confidence")) <= 1
        assert g == w
    assert got == want and got["total_files"] == 3
