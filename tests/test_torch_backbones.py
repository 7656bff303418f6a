"""The PCEN -> MobileNetV2 classifier of the port against the Flax model.

The Flax ``BackboneClassifier(mobilenet)`` is initialised by ``build_model``
and its BN scale and bias, conv and Dense biases and frontend parameters
are then randomized from a numpy seed.  Its BatchNorm statistics are each
layer's own batch moments on a calibration image (one train-mode pass),
perturbed from the seed: no BatchNorm is the identity, and every layer
keeps its input at unit scale, so the logits depend on the image and not
only on the biases (without the calibration, random statistics swamp the
signal and two images' logits agree to 1e-4).  The port loads the tree
through ``backbone_classifier_state_dict_from_flax``.  f32
logits agree to 1e-4 of max |logit| (both sides run exact f32 convolutions
on the CPU), in each frontend mode and with LME pooling, on small images and
at the production geometry.  The folded gray stem takes JAX's folded weights, and its
logits on the 1-channel image agree with the 3-channel repeat's to 1e-4 as
well: the fold is exact math, but the stem's f32 sums run in another order
and the net amplifies that as it does any rounding.  The whole slice
(``make_fused_infer_fn``: featurizer -> PCEN -> 3-channel repeat -> model)
is held against the JAX function at the production geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.infer.fused import make_fused_infer_fn as jax_infer_fn
from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu.models import fold_gray_stem as jax_fold_gray_stem
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
from audio_training_tpu_torch.models import (
    BackboneClassifier,
    build_model,
    fold_gray_stem,
)
from audio_training_tpu_torch.models.convert import (
    backbone_classifier_state_dict_from_flax,
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.models.layers import same_pads

from test_torch_badwinner2 import flax_variables as badwinner2_variables

torch.set_num_threads(2)

F32_REL = 1e-4
NUM_LABELS = 7
FRONTENDS = {"external": dict(external_frontend=True),
             "pcen": dict(use_pcen=True),
             "mag": dict(use_pcen=False),
             "lme": dict(external_frontend=True, lme=True)}


def _randomize(params, rng):
    """BN scale and bias, conv and Dense biases, from ``rng``.  Scales below
    1 keep the random 52-conv net contractive: at U(0.5, 1.5) it amplifies
    the packages' f32 rounding differences (3.6e-7 after PCEN) to 2e-4 of
    the logits, at U(0.3, 0.8) to about 3e-5."""
    for name, node in params.items():
        if name == "BatchNorm_0":
            n = node["scale"].shape[0]
            node["scale"] = rng.uniform(0.3, 0.8, n).astype(np.float32)
            node["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
        elif isinstance(node, dict):
            if "bias" in node and "kernel" in node:
                node["bias"] = rng.normal(
                    0.0, 0.05, node["bias"].shape).astype(np.float32)
            _randomize(node, rng)


def _calibrated_stats(module, v, x, rng):
    """Each BatchNorm's batch moments on ``x`` (Flax's train-mode update is
    0.99 running + 0.01 batch, from mean 0 and var 1), the mean moved by
    0.1 std and the var scaled by U(0.7, 1.4)."""
    _, upd = module.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
    upd = jax.tree_util.tree_map(lambda a: np.array(a, np.float64),
                                 upd["batch_stats"])

    def walk(node):
        if "mean" in node and "var" in node:
            mean = node["mean"] / 0.01
            var = np.maximum((node["var"] - 0.99) / 0.01, 0.0)
            n = mean.shape[0]
            node["mean"] = (mean + 0.1 * np.sqrt(var) * rng.normal(0, 1, n)
                            ).astype(np.float32)
            node["var"] = (var * rng.uniform(0.7, 1.4, n)).astype(np.float32)
            return
        for child in node.values():
            walk(child)

    walk(upd)
    return upd


def flax_classifier(shape, frontend, seed=0, num_labels=NUM_LABELS):
    """Flax BackboneClassifier(mobilenet) (module, variables), randomized,
    BN statistics calibrated on an image of ``shape``."""
    spec = jax_build_model("mobilenet", num_labels, logits_only=True,
                           **FRONTENDS[frontend])
    init = spec.module.init({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros(shape), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), init)
    rng = np.random.default_rng(seed + 100)
    _randomize(v["params"], rng)
    if frontend == "pcen":
        v["params"]["PCENLayer_0"] = {
            k: np.array([x], np.float32) for k, x in
            (("gain", 0.9), ("bias", 1.5), ("root", 2.5), ("smooth", 0.1))}
    if frontend == "mag":
        v["params"]["MagTransform_0"]["a_power"] = np.array([-0.6], np.float32)
    v["batch_stats"] = _calibrated_stats(
        spec.module, v, image(shape, frontend, seed + 200), rng)
    return spec, v


def port_classifier(variables, frontend, in_channels=3, **kw):
    model = build_model("mobilenet", NUM_LABELS, logits_only=True,
                        in_channels=in_channels, **FRONTENDS[frontend],
                        **kw).module
    model.load_state_dict(backbone_classifier_state_dict_from_flax(variables))
    return model.eval()


def image(shape, frontend, seed):
    rng = np.random.default_rng(seed)
    if frontend in ("external", "lme"):  # a PCEN image
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    return rng.gamma(2.0, 50.0, shape).astype(np.float32)  # mel power


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("frontend,shape", [
    ("external", (2, 32, 64, 3)),
    ("pcen", (2, 32, 64, 3)),
    ("mag", (2, 32, 64, 3)),
    ("lme", (2, 32, 64, 3)),  # log-mean-exp pooling before the average
    ("external", (1, 160, 513, 3)),  # production geometry: pads (0,1), (1,1)
])
def test_f32_logits_match_flax(frontend, shape):
    spec, v = flax_classifier(shape, frontend)
    x = image(shape, frontend, 1)
    want = spec.module.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_classifier(v, frontend)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (shape[0], NUM_LABELS)
    assert _rel(got, want) < F32_REL
    if shape[0] == 2:  # the logits follow the image, far above the tolerance
        assert _rel(want[0], want[1]) > 100 * F32_REL


@pytest.mark.parametrize("size,kernel,stride", [
    (160, 3, 2), (513, 3, 2), (80, 3, 1), (7, 3, 2), (20, 1, 1), (5, 1, 2),
])
def test_same_pads_are_xla_s(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert same_pads(size, kernel, stride) == tuple(want)


def test_fold_gray_stem_matches_jax():
    shape = (2, 32, 64, 3)
    spec, v = flax_classifier(shape, "external")
    x1 = image((2, 32, 64, 1), "external", 3)
    folded_v = jax_fold_gray_stem(spec, v)
    want = spec.module.apply(folded_v, jnp.asarray(x1), train=False)
    model = port_classifier(v, "external")
    folded = fold_gray_stem(model)
    assert model.backbone.stem.weight.shape == (32, 3, 3, 3)  # a copy
    assert folded.backbone.stem.weight.shape == (32, 1, 3, 3)
    port_from_jax = port_classifier(jax.tree_util.tree_map(np.asarray,
                                                           folded_v),
                                    "external", in_channels=1)
    np.testing.assert_allclose(
        folded.backbone.stem.weight.detach().numpy(),
        port_from_jax.backbone.stem.weight.detach().numpy(), rtol=1e-6,
        atol=1e-7)
    x3 = np.repeat(x1, 3, axis=-1)
    with torch.no_grad():
        got = folded(torch.from_numpy(x1))
        unfolded = model(torch.from_numpy(x3))
    assert _rel(got, want) < F32_REL
    assert _rel(got, unfolded) < F32_REL
    with pytest.raises(ValueError, match="exactly one"):
        fold_gray_stem(folded)
    with pytest.raises(ValueError, match="BackboneClassifier"):
        fold_gray_stem(torch.nn.Linear(2, 2))


def test_converter_refuses_other_trees():
    _, bw = badwinner2_variables((1, 96, 243, 1))
    with pytest.raises(ValueError, match="not a BackboneClassifier"):
        backbone_classifier_state_dict_from_flax(bw)
    _, v = flax_classifier((1, 32, 64, 3), "external")
    with pytest.raises(ValueError, match="not a badwinner2"):
        badwinner2_state_dict_from_flax(v)
    net = dict(v["params"]["MobileNetV2_0"])
    del net["InvertedResidual_16"]
    bad = {"params": dict(v["params"], MobileNetV2_0=net),
           "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="not a BackboneClassifier"):
        backbone_classifier_state_dict_from_flax(bad)


@pytest.mark.parametrize("folded,probabilities", [(False, False),
                                                  (True, True)])
def test_mobilenet_slice_matches_jax(folded, probabilities):
    """waveform -> featurizer -> PCEN -> (3-channel repeat) ->
    BackboneClassifier(mobilenet, external_frontend=True), production
    geometry, B=1, 62 labels, f32."""
    cfg = FeaturizerConfig()
    raw = np.random.default_rng(17).uniform(
        -1.0, 1.0, (1, cfg.samples_per_clip)).astype(np.float32)
    spec, v = flax_classifier((1, 160, 513, 3), "external", num_labels=62)
    model = build_model("mobilenet", 62, logits_only=True,
                        external_frontend=True).module
    model.load_state_dict(backbone_classifier_state_dict_from_flax(v))
    channels = 3
    if folded:
        v, model, channels = jax_fold_gray_stem(spec, v), fold_gray_stem(
            model), 1
    want = np.asarray(jax_infer_fn(
        spec.module, v, JaxConfig(), use_pcen=True, use_pallas=False,
        channels=channels, probabilities=probabilities)(jnp.asarray(raw)))
    got = make_fused_infer_fn(model, cfg, use_pcen=True, channels=channels,
                              probabilities=probabilities, device="cpu")(raw)
    assert got.shape == want.shape == (1, 62)
    assert _rel(got, want) < F32_REL


def test_build_model_guards_and_modes():
    g = torch.Generator().manual_seed(0)
    model = build_model("mobilenet", NUM_LABELS, generator=g).module
    assert isinstance(model, BackboneClassifier)
    assert model.pcen is not None and model.mag is None
    again = build_model("mobilenet", NUM_LABELS,
                        generator=torch.Generator().manual_seed(0)).module
    sd, sd2 = model.state_dict(), again.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    # training mode (batch moments, dropout from a generator) and sigmoid
    x = torch.from_numpy(image((2, 32, 64, 3), "pcen", 4))
    probs = model(x, generator=torch.Generator().manual_seed(1))
    assert probs.shape == (2, NUM_LABELS)
    assert bool(((probs > 0) & (probs < 1)).all())
    assert not torch.equal(sd["backbone.stem_bn.running_mean"],
                           torch.zeros(32))
    # bf16 compute: the pooled features are cast to f32 for the head
    model16 = build_model("mobilenet", NUM_LABELS, logits_only=True,
                          external_frontend=True,
                          dtype=torch.bfloat16).module.eval()
    out = model16(torch.rand(1, 32, 64, 3) * 2 - 1)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="Model families"):
        build_model("efficientnetv2b3", NUM_LABELS)
