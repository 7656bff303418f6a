"""The port's confusion tooling, ``test_set_metrics`` and TensorBoard event
writer against the JAX package's.

The confusion functions and ``test_set_metrics`` get the same ``y_true`` /
``y_pred`` from a numpy seed: integer outputs must be equal, float outputs
within 1e-12.  An event file written by the port's ``TBEventWriter`` must
parse, with JAX's ``read_events``, to what JAX's own writer's file parses
to, ``wall_time`` aside.
"""

import sys

import numpy as np
import pytest
import torch

from audio_training_tpu.eval import confusion as jconf
from audio_training_tpu.train import harness as jharness
from audio_training_tpu.utils import tensorboard as jtb
from audio_training_tpu_torch.eval import confusion as conf
from audio_training_tpu_torch.train import harness
from audio_training_tpu_torch.utils import tensorboard as tb

torch.set_num_threads(2)

FLOAT_TOL = 1e-12
LABELS = ["bird", "kiwi", "morepo2", "tui1", "rain"]


def _data(seed, n=40, multi=True):
    rng = np.random.default_rng(seed)
    if multi:
        y_true = (rng.random((n, len(LABELS))) < 0.3).astype(np.float32)
        y_true[:, 0] = np.maximum(y_true[:, 0], y_true[:, 1:4].max(1))
    else:
        y_true = np.eye(len(LABELS), dtype=np.float32)[
            rng.integers(0, len(LABELS), n)]
    y_pred = rng.random((n, len(LABELS))).astype(np.float32)
    y_pred[rng.random(n) < 0.2] *= 0.2  # some rows with nothing confident
    return y_true, y_pred


def _close(a, b):
    """Equal containers: integers and strings exactly, floats to 1e-12."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind in "iub":
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_functions_match_jax(seed):
    y_true, y_pred = _data(seed)
    _close(conf.multi_label_confusion(y_true, y_pred, LABELS),
           jconf.multi_label_confusion(y_true, y_pred, LABELS))
    y1, p1 = _data(seed + 10, multi=False)
    for threshold in (0.7, 0.3):
        _close(conf.single_label_confusion(y1, p1, LABELS, threshold),
               jconf.single_label_confusion(y1, p1, LABELS, threshold))
    ids = np.argmax(y1, 1)
    _close(conf.confusion_matrix(ids, np.argmax(p1, 1), len(LABELS)),
           jconf.confusion_matrix(ids, np.argmax(p1, 1), len(LABELS)))
    assert conf.display_labels(LABELS) == jconf.display_labels(LABELS)


@pytest.mark.parametrize("threshold", [0.5, 0.8])
@pytest.mark.parametrize("seed", [0, 3])
def test_test_set_metrics_match_jax(seed, threshold):
    y_true, y_pred = _data(seed)
    _close(harness.test_set_metrics(y_true, y_pred, LABELS, threshold),
           jharness.test_set_metrics(y_true, y_pred, LABELS, threshold))


def test_raw_predictions_and_model_mean_match_jax(tmp_path):
    dumps = []
    for i, m in enumerate((conf, jconf)):
        y_true, y_pred = _data(0, multi=False)
        y_pred = np.roll(y_pred, i, axis=1)
        path = m.save_raw_predictions(tmp_path / f"m{i}" / "confusion",
                                      LABELS, y_pred, y_true,
                                      tracks=[1, 2], recs=["a"], starts=[0.5])
        dumps.append(path)
    ours = [conf.load_raw_predictions(p) for p in dumps]
    theirs = [jconf.load_raw_predictions(p) for p in dumps]
    for a, b in zip(ours, theirs):
        _close({k: v for k, v in a.items() if k != "recs"},
               {k: v for k, v in b.items() if k != "recs"})
        assert list(a["recs"]) == list(b["recs"])
    _close(conf.mean_model_confusion(ours), jconf.mean_model_confusion(theirs))


def test_save_confusion_without_matplotlib_writes_the_npy(tmp_path,
                                                         monkeypatch):
    """The card's machine has no matplotlib: the .npy is written, the PNG
    skipped with a warning, and nothing raises."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cm = np.arange(9).reshape(3, 3)
    conf.save_confusion(cm, ["a", "b", "c"], tmp_path / "confusion")
    np.testing.assert_array_equal(np.load(tmp_path / "confusion.npy"), cm)
    assert not (tmp_path / "confusion.png").exists()


def _write_events(m, logdir):
    rng = np.random.default_rng(4)
    with m.TBEventWriter(logdir, filename_suffix="x") as w:
        for epoch in range(3):
            w.add_scalars({"loss": 0.5 / (epoch + 1), "val_auc": 0.75,
                           "lr": 1e-3, "name": "skipped"}, epoch)
            w.add_scalar("weights/mag.a_power", -1.0 + epoch / 8, epoch)
            counts, edges = np.histogram(rng.standard_normal(50), bins=16)
            w.add_histogram_counts("weights/convs.0.bias", counts, edges,
                                   epoch)
            w.add_histogram_values("weights/v", [0.1, 0.2, 0.4], epoch)
        w.add_image("epoch_confusion", _png(), 2)
    return w.path


def _png() -> bytes:
    """A minimal PNG header: the writer reads its IHDR size only."""
    return (b"\x89PNG\r\n\x1a\n" + b"\x00\x00\x00\rIHDR"
            + (7).to_bytes(4, "big") + (5).to_bytes(4, "big") + b"\x08\x06")


def _no_wall(events):
    return [{k: v for k, v in e.items() if k != "wall_time"} for e in events]


def test_event_file_matches_jax(tmp_path):
    ours = _write_events(tb, tmp_path / "port")
    theirs = _write_events(jtb, tmp_path / "jax")
    assert ours.name.startswith("events.out.tfevents.")
    want = _no_wall(jtb.read_events(theirs))
    assert _no_wall(jtb.read_events(ours)) == want
    assert _no_wall(tb.read_events(ours)) == want
    assert [e["step"] for e in want if "scalars" in e][:3] == [0, 0, 1]
