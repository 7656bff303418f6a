"""The port's Keras weight transplant (``models/transplant.py``) against the
JAX package's, on the CPU.

Without TensorFlow, through stand-in Keras models (``chip_smoke.
keras_stand_in``: plain objects named as Keras's layers, holding a port
model's tensors in Keras's layouts, in its call order): for badwinner2,
badwinner v1 (its MagTransform a scalar), wr-resnet and the PCEN ->
MobileNetV2 classifier (depthwise convs), the source weights are a
``torch_parity.Pair``'s (random, BatchNorms calibrated), and the same
stand-in goes through JAX ``transplant_keras_weights`` into Flax variables
made as Flax's ``init`` orders them, and through the port's into a model of
other weights.  ``state_dict_from_flax`` of JAX's result equals the port's
``state_dict`` bitwise, the f32 logits agree to 1e-4 of max |logit| (the
family tests' rule) and the port's slots come in JAX ``_flax_slots``'
order, path for path.  The refusals raise JAX's messages.

With TensorFlow (``tests.conftest.requires_tf``): keras.applications
MobileNetV2, EfficientNetB0 and EfficientNetV2B0 with ``weights=None`` and
randomized weights (``tests/test_tf_model_parity.py``'s rule), saved to a
``.weights.h5``; both packages' ``load_keras_backbone`` give the same
``backbone_args``, and the port's trunk matches Keras's ``predict`` at
JAX's ``rtol=1e-3, atol=1e-3``.  ``train_run(backbone_weights=...)`` trains
a step from the file (at learning rate 0, so the stem kernel stays Keras's
bitwise), and one train step from the transplanted classifier has JAX's
loss (``tests/test_torch_train_step.py``'s rule).  The sweep over every
``_KERAS_APP_BUILDERS`` name is slow-marked.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.models import transplant as jtransplant
from audio_training_tpu_torch.models import build_model, transplant
from audio_training_tpu_torch.models.convert import state_dict_from_flax

from chip_smoke import KerasModel, KerasWeight, keras_layer, keras_stand_in
from tests.conftest import requires_tf
from torch_parity import F32_REL, Pair, inputs_for, rel

torch.set_num_threads(2)

# name -> (input shape, stand-in options)
FAMILIES = {
    "badwinner2": ((2, 96, 120, 1), {}),
    "badwinner": ((2, 40, 60, 1), {"scalar_mag": True}),
    "wr-resnet": ((2, 30, 40, 1), {}),
    "mobilenet": ((2, 32, 40, 3), {}),
}


def creation_order_variables(module, inputs):
    """Zero-filled Flax variables of ``module`` with every dict in the order
    Flax's ``init`` creates it (``jax.eval_shape``'s output sorts the keys,
    and the JAX transplant pairs layers by creation order)."""
    order = []

    def init():
        v = module.init({"params": jax.random.PRNGKey(0)},
                        *[jnp.asarray(a) for a in inputs], train=False)
        order.extend(path for path, _ in jtransplant._walk(v))
        return v

    shapes = jax.eval_shape(init)
    out = {}
    for path in order:
        leaf = shapes
        for k in path:
            leaf = leaf[k]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(leaf.shape, leaf.dtype)
    return out


class Family:
    """A seeded, calibrated port model (the source), its stand-in Keras
    model, and both packages' transplants of it."""

    def __init__(self, name):
        shape, opts = FAMILIES[name]
        self.pair = Pair(name, shape, seed=3)
        self.inputs = inputs_for(self.pair, shape, 4)
        self.pair.calibrate(self.inputs)
        self.source = self.pair.port
        self.keras = keras_stand_in(self.source, **opts)
        self.fresh = lambda: build_model(
            name, 7, logits_only=True, n_mels=shape[1], mel_frames=shape[2],
            in_channels=shape[3],
            generator=torch.Generator().manual_seed(9)).module.eval()
        self.port = transplant.transplant_keras_weights(self.fresh(),
                                                        self.keras)
        self.jax_module = self.pair.jax.module
        self.jax_empty = creation_order_variables(self.jax_module,
                                                  self.inputs)
        self.jax_vars = jtransplant.transplant_keras_weights(self.jax_empty,
                                                             self.keras)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return Family(request.param)


def assert_state_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_state_dict_matches_jax_bitwise(family):
    want = state_dict_from_flax(family.fresh(), family.jax_vars)
    assert_state_dicts_equal(family.port.state_dict(), want)


def test_transplanted_tensors_equal_their_source(family):
    """Every tensor the stand-in carries comes back bitwise after the two
    layout changes (the port's to Keras's and back)."""
    assert_state_dicts_equal(family.port.state_dict(),
                             family.source.state_dict())


def test_logits_match_jax(family):
    want = np.asarray(family.jax_module.apply(
        family.jax_vars, *[jnp.asarray(a) for a in family.inputs],
        train=False))
    with torch.no_grad():
        got = family.port(*[torch.from_numpy(a)
                            for a in family.inputs]).numpy()
    assert got.dtype == np.float32 and np.isfinite(want).all()
    assert rel(got, want) < F32_REL
    assert rel(want[0], want[1]) > 100 * F32_REL


def test_slot_order_matches_jax(family):
    got = transplant.module_slots(family.port)
    want = jtransplant._flax_slots(family.jax_empty)
    assert got.keys() == want.keys()
    for kind in want:
        assert got[kind] == want[kind], kind
    kinds = transplant._keras_layers_by_kind(family.keras)
    assert {k: len(v) for k, v in kinds.items()} == {
        k: len(v) for k, v in want.items()}


def test_flax_tree_matches_jax_variables(family):
    """The port's Flax-layout tree has JAX's paths and shapes (its order
    across layer kinds is the port's registration order; within a kind it
    is Flax's, which the slot test holds)."""
    got = {p: v.shape for p, v in
           jtransplant._walk(transplant.flax_tree(family.port))}
    want = {p: v.shape for p, v in jtransplant._walk(family.jax_empty)}
    assert got == want


def _mutated(model: KerasModel, case: str) -> KerasModel:
    layers = list(model.layers)
    if case == "count":
        layers.pop(next(i for i, l in enumerate(layers)
                        if type(l).__name__ == "Conv2D"))
    elif case == "shape":
        i = next(i for i, l in enumerate(layers)
                 if type(l).__name__ == "Conv2D")
        kernel = layers[i].weights[0].numpy()
        bias = layers[i].bias
        layers[i] = keras_layer("Conv2D", [KerasWeight(kernel[..., :-1]),
                                           bias], use_bias=True, bias=bias)
    else:
        layers.append(keras_layer("Conv1D", [KerasWeight(np.zeros(3))]))
    return KerasModel(layers)


@pytest.mark.parametrize("case", ["count", "shape", "unknown_kind"])
def test_refusals_raise_jax_messages(family, case):
    """A count mismatch, a shape mismatch and an unknown layer kind raise
    JAX's ValueError message, and the port's module is left as it was."""
    bad = _mutated(family.keras, case)
    with pytest.raises(ValueError) as want:
        jtransplant.transplant_keras_weights(family.jax_empty, bad)
    target = family.fresh()
    before = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(ValueError) as got:
        transplant.transplant_keras_weights(target, bad)
    assert str(got.value) == str(want.value)
    assert_state_dicts_equal(target.state_dict(), before)


def test_backbone_into_classifier_matches_jax():
    """``transplant_backbone_into_classifier`` fills the MobileNetV2 trunk
    from a stand-in of the trunk alone: bitwise JAX's, the PCEN frontend
    and Dense head kept."""
    fam = Family("mobilenet")
    keras = keras_stand_in(fam.source.backbone)
    target = fam.fresh()
    kept = {k: v.clone() for k, v in target.state_dict().items()
            if not k.startswith("backbone.")}
    transplant.transplant_backbone_into_classifier(target, keras)
    want = jtransplant.transplant_backbone_into_classifier(
        transplant.flax_tree(fam.fresh()), keras)
    assert_state_dicts_equal(target.state_dict(),
                             state_dict_from_flax(fam.fresh(), want))
    sd = target.state_dict()
    assert_state_dicts_equal({k: v for k, v in sd.items() if k in kept},
                             kept)
    assert_state_dicts_equal(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")}, fam.source.backbone.state_dict())
    # a model without one backbone submodule is refused as in JAX
    bw2 = Family("badwinner2")
    with pytest.raises(ValueError) as want_err:
        jtransplant.transplant_backbone_into_classifier(bw2.jax_empty, keras)
    with pytest.raises(ValueError) as got_err:
        transplant.transplant_backbone_into_classifier(bw2.fresh(), keras)
    # JAX lists the keys in Flax's creation order, the port in its own
    # registration order: the same message, the same keys
    import ast

    prefix = "expected exactly one backbone submodule, found "
    got_msg, want_msg = str(got_err.value), str(want_err.value)
    assert got_msg.startswith(prefix) and want_msg.startswith(prefix)
    assert sorted(ast.literal_eval(got_msg[len(prefix):])) == sorted(
        ast.literal_eval(want_msg[len(prefix):]))


def test_normalization_constants_match_jax():
    """The stem's Normalization statistics are read from a nested
    sub-model; a Normalization without weights is skipped; nested models
    flatten into the layer kinds as in JAX."""
    norm = keras_layer("Normalization", [KerasWeight(np.zeros(3))],
                       mean=np.array([[0.1, 0.2, 0.3]], np.float32),
                       variance=np.array([[1.5, 2.5, 3.5]], np.float32))
    empty = keras_layer("Normalization", [])
    inner = KerasModel([empty, norm, keras_layer(
        "Conv2D", [KerasWeight(np.ones((3, 3, 3, 4), np.float32))],
        use_bias=False, bias=None)])
    outer = KerasModel([keras_layer("Rescaling", []), inner])
    for model in (outer, inner, KerasModel([empty])):
        assert (transplant.normalization_constants(model)
                == jtransplant.normalization_constants(model))
    assert transplant.normalization_constants(outer) == (
        tuple(float(v) for v in np.float32([0.1, 0.2, 0.3])),
        tuple(float(v) for v in np.float32([1.5, 2.5, 3.5])))
    got = transplant._keras_layers_by_kind(outer)
    want = jtransplant._keras_layers_by_kind(outer)
    assert {k: [id(l) for l in v] for k, v in got.items()} == {
        k: [id(l) for l in v] for k, v in want.items()}


@pytest.mark.parametrize("case", ["unknown_name", "missing_file",
                                  "no_tensorflow"])
def test_load_keras_backbone_refusals_match_jax(case, tmp_path, monkeypatch):
    """An unknown backbone name, a missing weight file and a machine
    without TensorFlow raise JAX's errors with JAX's messages."""
    path = tmp_path / "notop.weights.h5"
    name = "badwinner2" if case == "unknown_name" else "mobilenet"
    if case == "no_tensorflow":
        path.write_bytes(b"")
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    errors = {"unknown_name": ValueError, "missing_file": FileNotFoundError,
              "no_tensorflow": RuntimeError}
    with pytest.raises(errors[case]) as want:
        jtransplant.load_keras_backbone(name, path, (32, 32, 3))
    with pytest.raises(errors[case]) as got:
        transplant.load_keras_backbone(name, path, (32, 32, 3))
    assert str(got.value) == str(want.value)
    assert transplant._KERAS_APP_BUILDERS == jtransplant._KERAS_APP_BUILDERS
    assert transplant.IMAGENET_STDDEV_RGB == jtransplant.IMAGENET_STDDEV_RGB


@pytest.mark.parametrize("name", [
    "badwinner2", "dual-badwinner2", "merge", "cnn-features", "embeddings",
    "wr-resnet-bird", "efficientnetb0", "efficientnetv2b0", "densenet121",
    "inceptionv3"])
def test_flax_tree_round_trips(name):
    """``state_dict_from_flax(m, flax_tree(m))`` is ``m``'s own state_dict,
    bitwise: the layout probe inverts every layout change."""
    model = build_model(name, 5, logits_only=True, n_mels=96, mel_frames=120,
                        generator=torch.Generator().manual_seed(1)).module
    assert_state_dicts_equal(
        state_dict_from_flax(model, transplant.flax_tree(model)),
        model.state_dict())


def test_convert_takes_an_empty_batch_stats_collection():
    """JAX's checkpoints and ``load_predictor`` carry ``batch_stats: {}``
    for a model without BatchNorm (the ``embeddings`` probe); the converter
    takes it as no variable, and still refuses an empty scope inside a
    collection."""
    model = build_model("embeddings", 4, logits_only=True).module
    params = transplant.flax_tree(model)["params"]
    want = state_dict_from_flax(model, {"params": params})
    assert_state_dicts_equal(
        state_dict_from_flax(model, {"params": params, "batch_stats": {}}),
        want)
    with pytest.raises(ValueError, match="unexpected"):
        state_dict_from_flax(model, {"params": params,
                                    "batch_stats": {"Dense_0": {}}})


# ---------------------------------------------------------------------------
# With TensorFlow: keras.applications graphs
# ---------------------------------------------------------------------------

KERAS_SHAPE = (64, 72, 3)
APPS = {"mobilenet": "MobileNetV2", "efficientnetb0": "EfficientNetB0",
        "efficientnetv2b0": "EfficientNetV2B0"}


@pytest.fixture(scope="module")
def tf():
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    return tf


def _randomize(model, seed):
    from test_tf_model_parity import _randomize_keras_weights

    _randomize_keras_weights(None, model, seed=seed, scaled=True)


def _saved_app(tf, tmp_path, name, shape, seed):
    model = getattr(tf.keras.applications, APPS.get(
        name, jtransplant._KERAS_APP_BUILDERS[name]))(
        weights=None, include_top=False, input_shape=shape)
    _randomize(model, seed)
    path = tmp_path / f"{name}.weights.h5"
    model.save_weights(str(path))
    return model, path


def _app_input(name, shape, seed):
    rng = np.random.default_rng(seed)
    if name.startswith("efficientnet"):  # the graphs rescale x / 255
        return rng.uniform(0.0, 255.0, (2, *shape)).astype(np.float32)
    return rng.normal(0.0, 1.0, (2, *shape)).astype(np.float32)


@requires_tf
@pytest.mark.parametrize("name", sorted(APPS))
def test_keras_application_trunk_matches_keras(tf, tmp_path, name):
    """Both packages' ``load_keras_backbone`` give equal ``backbone_args``
    (with and without the ImageNet rescale); the port's trunk from the
    loaded graph matches Keras's ``predict`` at rtol=1e-3, atol=1e-3."""
    from audio_training_tpu_torch.models.backbones import BACKBONES

    source, path = _saved_app(tf, tmp_path, name, KERAS_SHAPE, 31)
    for stats in (True, False):
        _, want = jtransplant.load_keras_backbone(name, path, KERAS_SHAPE,
                                                  imagenet_stats=stats)
        keras, args = transplant.load_keras_backbone(name, path, KERAS_SHAPE,
                                                     imagenet_stats=stats)
        assert args == want
    trunk = BACKBONES[name](3, **dict(args)).eval()
    transplant.transplant_keras_weights(trunk, keras)
    x = _app_input(name, KERAS_SHAPE, 32)
    ref = source.predict(x, verbose=0)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@requires_tf
def test_train_run_starts_from_the_backbone_weights(tf, tmp_path):
    """``train_run(backbone_weights=...)`` (and ``cli/train
    --backbone-weights``) train a MobileNetV2 run from a Keras weight file:
    at learning rate 0 the saved stem kernel is Keras's, bitwise."""
    from audio_training_tpu_torch.cli import train as cli
    from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
    from audio_training_tpu_torch.train import harness
    from audio_training_tpu_torch.train.checkpoints import load_state_dict

    from test_torch_harness import GEOMETRY, write_corpus

    cfg = FeaturizerConfig(**GEOMETRY)
    corpus = write_corpus(tmp_path / "corpus", cfg)
    shape = (cfg.n_mels, cfg.mel_frames, cfg.channels)
    keras, path = _saved_app(tf, tmp_path, "mobilenet", shape, 33)
    stem = keras.get_layer("Conv1").weights[0].numpy()
    want = torch.from_numpy(stem).permute(3, 2, 0, 1)
    train_cfg = TrainConfig(model_name="mobilenet", batch_size=4,
                            learning_rate=0.0, epochs=1,
                            compute_dtype="float32")
    result = harness.train_run(
        [corpus], "bb", checkpoint_root=tmp_path, train_cfg=train_cfg,
        featurizer=cfg, steps_per_epoch=1, backbone_weights=path,
        backbone_imagenet_stats=False, device="cpu")
    assert np.isfinite(result.history["loss"][0])
    sd = load_state_dict(result.run_dir / "chkpt.pt")
    assert torch.equal(sd["backbone.stem.weight"], want)
    conf = tmp_path / "train.json"
    conf.write_text('{"compute_dtype": "float32", "learning_rate": 0.0}')
    assert cli.main(["cli", "-d", str(corpus), "--checkpoint-dir",
                     str(tmp_path), "--model-name", "mobilenet",
                     "--batch-size", "4", "--epochs", "1",
                     "--steps-per-epoch", "1", "-c", str(conf),
                     "--backbone-weights", str(path),
                     "--backbone-weights-custom", "--device", "cpu"]) == 0
    sd = load_state_dict(tmp_path / "cli" / "chkpt.pt")
    assert torch.equal(sd["backbone.stem.weight"], want)


@requires_tf
def test_first_step_loss_matches_jax(tf, tmp_path):
    """One train step of the PCEN -> MobileNetV2 classifier whose trunk both
    packages transplanted from one Keras graph (the frontend and head the
    port's, carried to JAX by ``flax_tree``), on the same f32 batch with
    dropout 0: the step's loss (taken before the update) agrees with JAX's
    train-mode loss to 5e-5 relative (tests/test_torch_train_step.py's
    rule for JAX's jitted step)."""
    from audio_training_tpu.models import build_model as jax_build_model
    from audio_training_tpu.train import losses as jlosses
    from audio_training_tpu_torch.train import step
    from audio_training_tpu_torch.train.metrics import metrics_compute
    from audio_training_tpu_torch.train.state import create_train_state

    shape = (32, 40, 3)
    keras, _ = _saved_app(tf, tmp_path, "mobilenet", shape, 34)
    port = build_model("mobilenet", 5, logits_only=True, dropout=0.0,
                       generator=torch.Generator().manual_seed(2)).module
    variables = jtransplant.transplant_backbone_into_classifier(
        transplant.flax_tree(port), keras)
    transplant.transplant_backbone_into_classifier(port, keras)
    rng = np.random.default_rng(35)
    mel = rng.gamma(2.0, 50.0, (2, *shape)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[1, 3]]

    state = create_train_state(port, learning_rate=1e-3, device="cpu")
    _, m = step.make_train_step()(
        state, step.fresh_metrics(), torch.from_numpy(mel),
        torch.from_numpy(y), torch.Generator().manual_seed(0))
    got = metrics_compute(m)["loss"]

    jmod = jax_build_model("mobilenet", 5, logits_only=True,
                           dropout=0.0).module

    @jax.jit
    def loss(v, x, t):
        out, _ = jmod.apply(v, x, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.bce_from_logits(out, t)

    want = float(loss(variables, jnp.asarray(mel), jnp.asarray(y)))
    assert np.isfinite(want)
    assert abs(got - want) <= 5e-5 * abs(want)


@requires_tf
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(jtransplant._KERAS_APP_BUILDERS))
def test_every_keras_application_matches_keras(tf, tmp_path, name):
    """Every keras.applications backbone of ``_KERAS_APP_BUILDERS``
    (EfficientNetV2-B3, the reference's default, among them)."""
    from audio_training_tpu_torch.models.backbones import BACKBONES

    shape = (75, 80, 3)
    source, path = _saved_app(tf, tmp_path, name, shape, 36)
    keras, args = transplant.load_keras_backbone(name, path, shape,
                                                 imagenet_stats=False)
    _, want = jtransplant.load_keras_backbone(name, path, shape,
                                              imagenet_stats=False)
    assert args == want
    trunk = BACKBONES[name](3, **dict(args)).eval()
    transplant.transplant_keras_weights(trunk, keras)
    x = _app_input(name, shape, 37)
    ref = source.predict(x, verbose=0)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
