"""The training QUALITY gate, ported: the JAX package's ``cli/build`` builds
a fixed synthetic corpus of separable classes, the port's ``train_run``
trains badwinner2 on it (on the CPU), and the held-out test confusion must
clear the bars of ``tests/test_quality_gate.py:120-150``: 0.7 overall, 0.8
on the specific-species rows, every populated row's maximum on the
diagonal.  The trained run is then frozen by the port's ``cli/freeze`` and
its deployment scored on fresh clips by the port's ``evaluate_strong_dir``
against the bar of ``tests/test_quality_gate.py:150-190`` (0.8 on the
species rows).  A second run builds the same corpus with the port's own
``cli/build`` and must clear the same training bars.  Slow (outside
tier-1): two full small trainings.
"""

import json

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.train.harness import train_run
from tests.test_quality_gate import (
    EBIRD,
    LABELS,
    SR,
    TONE_END,
    TONE_START,
    _tone_clip,
    _write_corpus,
)

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


def _build_and_train(build_main, tmp_path_factory):
    corpus = tmp_path_factory.mktemp("gate_corpus")
    out = tmp_path_factory.mktemp("gate_out")
    _write_corpus(corpus)
    rc = build_main([
        str(out), "-d", str(corpus),
        "--sr", str(SR), "--n-fft", "512",
        "--seg-length", "3", "--stride", "1",
        "--mels", "96", "--fmin", "100", "--fmax", "3500",
        "--hop-length", "100",
        "--dont-tighten-tracks", "--dont-filter-rms",
        "--workers", "1",
    ])
    assert rc == 0
    featurizer = FeaturizerConfig(
        sr=SR, n_fft=512, hop_length=100, n_mels=96, fmin=100, fmax=3500,
    )
    cfg = TrainConfig(
        model_name="badwinner2", batch_size=8, learning_rate=1e-3,
        epochs=8, compute_dtype="float32", epoch_confusion=True,
        early_stop_patience=50, bn_reestimate=True,
    )
    return train_run(
        [out / "training-data"], "gaterun",
        checkpoint_root=tmp_path_factory.mktemp("gate_ckpt"),
        train_cfg=cfg, featurizer=featurizer, epochs=8, device="cpu",
    )


@pytest.fixture(scope="module")
def gate_run(tmp_path_factory):
    """JAX build CLI -> the port's training, as the JAX gate's fixture
    (tests/test_quality_gate.py:75-117) with the port's train_run."""
    from audio_training_tpu.cli.build import main as build_main

    return _build_and_train(build_main, tmp_path_factory)


@pytest.fixture(scope="module")
def port_gate_run(tmp_path_factory):
    """The same corpus built by the port's ``cli/build``, then the port's
    training."""
    from audio_training_tpu_torch.cli.build import main as build_main

    return _build_and_train(build_main, tmp_path_factory)


def test_training_quality_bar(gate_run):
    """The train loss falls and the post-BN-re-estimation test confusion
    clears 0.7 overall and 0.8 on the specific-species rows (row 0 is the
    generic 'bird' output)."""
    result = gate_run
    assert result.history["loss"][-1] < result.history["loss"][0]
    cm = np.load(result.run_dir / "confusion.npy")
    total = cm.sum()
    assert total > 0
    overall = np.trace(cm) / total
    assert overall >= 0.7, cm
    sp = cm[1:4]
    assert sp.sum() > 0
    assert np.trace(cm[1:4, 1:4]) / sp.sum() >= 0.8, cm


def test_test_split_confusion_quality(gate_run):
    """Every row with any mass has its maximum on the diagonal."""
    cm = np.load(gate_run.run_dir / "confusion.npy")
    for i in range(min(cm.shape)):
        if cm[i].sum() > 0:
            assert cm[i, i] == cm[i].max(), cm


def test_strong_eval_deployment_quality(gate_run, tmp_path):
    """Deployment-path accuracy on fresh clips (the JAX gate's
    test_strong_eval_deployment_quality with the port's cli/freeze,
    load_predictor and evaluate_strong_dir): every species row of the mean
    confusion puts 0.8 of its mass on the diagonal."""
    from scipy.io import wavfile

    from audio_training_tpu_torch.cli import freeze
    from audio_training_tpu_torch.cli.predict import load_predictor
    from audio_training_tpu_torch.eval.strong import evaluate_strong_dir

    rng = np.random.default_rng(99)
    eval_dir = tmp_path / "strong"
    eval_dir.mkdir()
    for i, what in enumerate(LABELS * 2):
        wavfile.write(eval_dir / f"fresh{i}.wav", SR, _tone_clip(rng, what))
        (eval_dir / f"fresh{i}.txt").write_text(json.dumps({
            "id": f"fresh{i}", "duration": 8.0,
            "Tracks": [{
                "id": f"ft{i}", "start": TONE_START, "end": TONE_END,
                "tags": [{"what": EBIRD[what], "automatic": False}],
            }],
        }))
    deploy = tmp_path / "deploy"
    assert freeze.main([str(gate_run.run_dir), str(deploy), "-w",
                        "chkpt"]) == 0
    predictor, meta = load_predictor(deploy, "audioModel", device="cpu")
    assert meta["frozen"]
    res = evaluate_strong_dir(predictor, eval_dir, workers=1)
    cm = res.mean_cm
    idx = [res.labels.index(EBIRD[w]) for w in LABELS]
    sp_total = cm[idx].sum()
    assert sp_total >= len(LABELS) * 2  # every track evaluated
    assert sum(cm[i, i] for i in idx) / sp_total >= 0.8, (res.labels, cm)


def test_port_build_training_quality(port_gate_run):
    """The port's ``cli/build`` -> ``train_run`` clears the bars of the two
    tests above."""
    test_training_quality_bar(port_gate_run)
    test_test_split_confusion_quality(port_gate_run)
