"""``fit`` of the port end to end on the CPU: synthetic, learnable batches
(labels carried by tone bands, from a numpy seed) -> mixup preprocess ->
badwinner2 (96 mels, 0.75 s clips, B=2) -> Adam, with validation.  The
train loss falls; the run directory holds the per-metric weights files,
``chkpt.pt``, ``best.json``, ``training-log.csv`` and ``history.json``; a
non-finite epoch is rolled back; and the written ``val-loss.pt`` loads and
predicts through the port's ``cli/predict``.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio_training_tpu_torch.cli import predict
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.train import (
    create_train_state,
    fit,
    load_state_dict,
    make_predict_fn,
)

torch.set_num_threads(2)

CFG = dict(segment_length=0.75, n_mels=96)
LABELS = ["low", "high"]
TONES = (800.0, 4000.0)  # the band that carries each label


def _clips(labels, seed, n=36000, sr=48000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return np.stack([np.sin(2 * np.pi * TONES[l] * t + rng.uniform(0, 6))
                     + 0.1 * rng.standard_normal(n)
                     for l in labels]).astype(np.float32)


def _batches(epoch):
    for i in range(2):
        raw, raw2 = _clips([0, 1], 10 * epoch + i), _clips([1, 0], 99 + i)
        y = np.eye(2, dtype=np.float32)
        yield raw, y, raw2, y[::-1].copy()


def _state(seed=0):
    model = build_model("badwinner2", 2, logits_only=True, n_mels=96,
                        generator=torch.Generator().manual_seed(seed)).module
    return create_train_state(model, learning_rate=1e-3, device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = FeaturizerConfig(**CFG)
    run_dir = tmp_path_factory.mktemp("fit") / "run"
    val = (_clips([0, 1], 500), np.eye(2, dtype=np.float32))
    result = fit(
        _state(), _batches,
        make_preprocess_fn(cfg, augment=True, backend="fused", device="cpu"),
        epochs=4, val_batches=lambda: [val],
        val_preprocess=make_preprocess_fn(cfg, device="cpu"),
        run_dir=run_dir,
    )
    return result, run_dir, val


def test_fit_loss_falls_and_writes_the_run_dir(trained):
    result, run_dir, _ = trained
    hist = result.history
    assert result.epochs_run == 4
    assert hist["loss"][-1] < hist["loss"][0]
    assert hist["lr"] == [1e-3] * 4
    for name in ("val-loss.pt", "val-auc.pt", "val-accuracy.pt", "chkpt.pt",
                 "best.json", "training-log.csv", "history.json"):
        assert (run_dir / name).exists(), name
    assert json.loads((run_dir / "history.json").read_text()) == hist
    best = json.loads((run_dir / "best.json").read_text())
    assert best["val_loss"] == min(hist["val_loss"])
    rows = (run_dir / "training-log.csv").read_text().splitlines()
    assert rows[0].split(",")[0] == "epoch" and len(rows) == 5


def test_best_weights_reload_and_predict(trained):
    result, run_dir, (val_raw, val_y) = trained
    state = _state(seed=7)
    state.model.load_state_dict(load_state_dict(run_dir / "val-loss.pt"))
    mel, _ = make_preprocess_fn(FeaturizerConfig(**CFG), device="cpu")(
        val_raw, val_y)
    probs = make_predict_fn()(state, mel)
    assert probs.shape == (2, 2) and bool(torch.isfinite(probs).all())


def test_val_loss_weights_predict_through_the_cli(trained, tmp_path):
    _, run_dir, _ = trained
    meta = {"name": "badwinner2", "labels": LABELS, "ebird_labels": LABELS,
            "multi_label": True, "channels": 1, "featurizer": CFG}
    (run_dir / "metadata.txt").write_text(json.dumps(meta))
    sr = 48000
    t = np.arange(sr * 6) / sr
    rec = (np.sin(2 * np.pi * 4000.0 * t) * (t % 3 < 1.2)
           + 0.01 * np.random.default_rng(0).standard_normal(len(t)))
    wav = tmp_path / "rec.wav"
    wavfile.write(wav, sr, rec.astype(np.float32))
    out = tmp_path / "out.json"
    assert predict.main([str(run_dir), "--file", str(wav), "--threshold",
                         "0.0", "--json-out", str(out),
                         "--device", "cpu"]) == 0
    tracks = json.loads(out.read_text())[str(wav)]
    assert tracks and all(tr["predictions"] for tr in tracks)


def test_fit_rolls_back_a_non_finite_epoch(tmp_path):
    cfg = FeaturizerConfig(**CFG)
    preprocess = make_preprocess_fn(cfg, device="cpu")
    raw, y = _clips([0, 1], 1), np.eye(2, dtype=np.float32)

    def batches(epoch):
        yield (np.full_like(raw, np.inf) if epoch == 1 else raw), y

    result = fit(_state(), batches, preprocess, epochs=3, run_dir=tmp_path,
                 augment=False)
    losses = result.history["loss"]
    assert len(losses) == 3
    assert np.isfinite(losses[0]) and np.isfinite(losses[2])
    assert not np.isfinite(losses[1])
    # the restore also resets the Adam moments, which the NaN poisoned
    state = result.state
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert all(torch.isfinite(v).all() for s in state.optimizer.state.values()
               for v in s.values())

    # two poisoned epochs in a row abort the run
    bad = fit(_state(), lambda e: [(np.full_like(raw, np.inf), y)],
              preprocess, epochs=5, run_dir=tmp_path / "bad", augment=False)
    assert bad.epochs_run <= 3


def test_unported_fit_options_raise():
    """``remat=True`` reaches the train step: one epoch with it gives
    ``remat=False``'s losses and weights (dropout masks replayed, BN
    statistics updated once)."""
    preprocess = make_preprocess_fn(FeaturizerConfig(**CFG), augment=True,
                                    device="cpu")
    runs = [fit(_state(), _batches, preprocess, epochs=1, remat=remat)
            for remat in (False, True)]
    assert runs[0].history["loss"] == runs[1].history["loss"]
    want, got = (r.state.model.state_dict() for r in runs)
    assert all(torch.equal(want[k], got[k]) for k in want)
