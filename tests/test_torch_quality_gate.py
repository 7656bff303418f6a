"""The training QUALITY gate, ported: the JAX package's ``cli/build`` builds
a fixed synthetic corpus of separable classes, the port's ``train_run``
trains badwinner2 on it (on the CPU), and the held-out test confusion must
clear the bars of ``tests/test_quality_gate.py:120-150``: 0.7 overall, 0.8
on the specific-species rows, every populated row's maximum on the
diagonal.  Slow (outside tier-1): a full small training.
"""

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.train.harness import train_run
from tests.test_quality_gate import SR, _write_corpus

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def gate_run(tmp_path_factory):
    """JAX build CLI -> the port's training, as the JAX gate's fixture
    (tests/test_quality_gate.py:75-117) with the port's train_run."""
    from audio_training_tpu.cli.build import main as build_main

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
