"""The small model families of the port against the Flax models, the
registry's names and refusals, and training a family through the CLI.

badwinner2 with ``big_condense=False`` / ``add_dense=False``,
badwinner2-res (both condense forms), badwinner (v1), wr-resnet,
wr-resnet-bird (both ``keras_slip_compat`` modes), dual-badwinner2, merge,
cnn-features, embeddings and the hand-rolled ResNet50 of ``resnet.py``, each
at a small image (B=2): f32 outputs agree to 1e-4 of max |output| under
weights carried by ``models/convert.state_dict_from_flax`` (set-up in
tests/torch_parity.py).  Every name of JAX's ``MODEL_NAMES`` builds (or,
``rf-features``, raises as JAX's does), and ``cli/train`` / ``train_run``
train mel families on the harness tests' tiny corpus, whose runs
``cli/predict`` loads.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.models import MODEL_NAMES as JAX_MODEL_NAMES
from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu.models.resnet import ResNet50 as JaxResNet50
from audio_training_tpu_torch.cli import predict
from audio_training_tpu_torch.cli import train as cli
from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.models import MODEL_NAMES, build_model
from audio_training_tpu_torch.models.convert import state_dict_from_flax
from audio_training_tpu_torch.models.registry import (
    build_random_forest,
    rf_backends,
)
from audio_training_tpu_torch.models.resnet import ResNet50
from audio_training_tpu_torch.train import harness, metadata

from test_torch_harness import FREQS, GEOMETRY, write_corpus
from torch_parity import F32_REL, _fill, calibrate, check_family, rel

torch.set_num_threads(2)


@pytest.mark.parametrize("name,shape,kw", [
    ("badwinner2", (2, 160, 120, 1), {"big_condense": False}),
    ("badwinner2", (2, 96, 120, 1), {"add_dense": False}),
    ("badwinner2", (2, 96, 120, 3), {"multi_label": False, "lme": True}),
    ("badwinner2-res", (2, 160, 120, 1), {}),
    ("badwinner2-res", (2, 160, 120, 1), {"big_condense": False}),
    ("badwinner", (2, 40, 60, 1), {}),
    ("wr-resnet", (2, 30, 40, 1), {}),
    ("wr-resnet-bird", (2, 32, 64, 1), {}),
    ("wr-resnet-bird", (2, 32, 64, 1), {"keras_slip_compat": True}),
    ("dual-badwinner2", (2, 96, 120, 1), {}),
    ("merge", (2, 96, 120, 1), {}),
    ("cnn-features", (2, 1, 1, 1), {}),
    ("embeddings", (2, 1, 1, 1), {}),
])
def test_family_logits_match_flax(name, shape, kw):
    check_family(name, shape, kw)


def test_wr_resnet_bird_compat_reads_the_geometry():
    """Under keras_slip_compat the widths and the Dense follow the image:
    the pre-conv of stage 1 is n_mels wide, the Dense reads frames // 16."""
    model = build_model("wr-resnet-bird", 5, n_mels=160, mel_frames=513,
                        keras_slip_compat=True).module
    assert model.blocks[0].pre.weight.shape[0] == 160
    assert model.dense.weight.shape == (5, 32)
    plain = build_model("wr-resnet-bird", 5, n_mels=160).module
    assert plain.blocks[0].pre.weight.shape[0] == 16
    assert plain.dense.weight.shape == (5, 5)


def test_resnet50_features_match_flax():
    """The hand-rolled ResNet50 (resnet.py): VALID 3x3/2 pool without a
    pad, stride on the first 1x1, a 2x2/2 average pool and an NHWC
    flatten."""
    shape = (2, 102, 136, 3)  # a 2 x 2 map after the last pool
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    module = JaxResNet50()
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    v = _fill(jax.tree_util.tree_map(lambda a: a, dict(shapes)), rng)
    port = ResNet50(3)
    port.load_state_dict(state_dict_from_flax(port, v))
    more = rng.uniform(-1.0, 1.0, (6,) + shape[1:]).astype(np.float32)
    calibrate(port, v, [torch.from_numpy(np.concatenate([x, more])).permute(
        0, 3, 1, 2)], rng)
    want = np.asarray(module.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2 * 2 * 2048)
    assert rel(got, want) < F32_REL
    assert rel(want[0], want[1]) > 100 * F32_REL


def test_every_jax_model_name_builds():
    assert MODEL_NAMES == JAX_MODEL_NAMES and len(MODEL_NAMES) == 26
    for name in MODEL_NAMES:
        if name == "rf-features":
            for build in (build_model, jax_build_model):
                with pytest.raises(ValueError, match="random-forest"):
                    build(name, 3)
            continue
        spec = build_model(name, 3)
        assert spec.inputs == jax_build_model(name, 3).inputs, name
    with pytest.raises(ValueError, match="Unknown model name"):
        build_model("not-a-model", 2)


def test_random_forest():
    """JAX's case (tests/test_models.py), on scikit-learn."""
    assert rf_backends() == ["sklearn"]
    rf = build_random_forest(n_estimators=5)
    assert rf.n_estimators == 5 and build_random_forest().n_estimators == 300
    x = np.random.default_rng(9).random((40, 10))
    y = (x[:, 0] > 0.5).astype(int)
    assert rf.fit(x, y).score(x, y) > 0.9
    for backend in ("ydf", "xgboost"):
        with pytest.raises(ValueError, match="unknown rf backend"):
            build_random_forest(backend)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"),
                        FeaturizerConfig(**GEOMETRY))


def test_cli_trains_the_default_backbone(corpus, tmp_path):
    """``cli/train --model-name efficientnetv2b3`` (1-channel mel, its own
    PCEN layer), then ``cli/predict.load_predictor`` serves the run."""
    conf = tmp_path / "train.json"
    conf.write_text(json.dumps({"compute_dtype": "float32"}))
    assert cli.main(["b3", "-d", str(corpus), "--checkpoint-dir",
                     str(tmp_path), "--model-name", "efficientnetv2b3",
                     "--batch-size", "4", "--epochs", "1",
                     "--steps-per-epoch", "2", "-c", str(conf),
                     "--device", "cpu"]) == 0
    run_dir = tmp_path / "b3"
    meta = metadata.load_metadata(run_dir)
    assert meta["name"] == "efficientnetv2b3"
    assert np.isfinite(meta["history"]["loss"]).all()
    predictor, _ = predict.load_predictor(run_dir, "val-loss", device="cpu")
    assert predictor.module.backbone.out_channels == 1536
    sr = GEOMETRY["sr"]
    t = np.arange(3 * sr) / sr
    window = np.sin(2 * np.pi * FREQS[1] * t).astype(np.float32)[None]
    probs = predictor.predict_windows(window)
    assert probs.shape == (1, len(predictor.labels))
    assert np.isfinite(probs).all()


def test_train_run_trains_a_mel_family(corpus, tmp_path):
    result = harness.train_run(
        [corpus], "wr", checkpoint_root=tmp_path,
        train_cfg=TrainConfig(model_name="wr-resnet", batch_size=4,
                              epochs=1, compute_dtype="float32"),
        featurizer=FeaturizerConfig(**GEOMETRY), steps_per_epoch=2,
        device="cpu")
    assert np.isfinite(result.history["loss"]).all()
    predictor, _ = predict.load_predictor(result.run_dir, "chkpt",
                                          device="cpu")
    assert predictor.labels == result.labels
