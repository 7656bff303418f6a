"""EfficientNet and EfficientNetV2 of the port against the Flax models,
led by the reference's default backbone, EfficientNetV2-B3.

Each variant behind ``BackboneClassifier`` at 33 x 47 (B=2), and B3 at the
production geometry (160 mels x 513 frames) on a 3-channel image (the
ImageNet branch of its baked preprocessing) and on a 1-channel mel power
image through its own PCEN layer (the ``x / 128 - 1`` branch, as training
at ``channels=1`` runs it): f32 logits agree to 1e-4 of max |logit| under
weights carried by ``models/convert.state_dict_from_flax`` (set-up in
tests/torch_parity.py).  The whole slice (``make_fused_infer_fn``:
featurizer -> PCEN -> 3-channel repeat -> B3) is held against the JAX
function; the gray-stem fold refuses what JAX's refuses; train mode (BN on
batch moments, dropout off) agrees in logits and updated statistics.
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
from audio_training_tpu_torch.models import build_model, fold_gray_stem
from audio_training_tpu_torch.models.convert import (
    flax_leaf_map,
    state_dict_from_flax,
)

from torch_parity import F32_REL, Pair, check_family, inputs_for, rel

torch.set_num_threads(2)

EXTERNAL = {"external_frontend": True}
PRODUCTION = (2, 160, 513, 3)
IMAGENET = (("norm_mean", (0.485, 0.456, 0.406)),
            ("norm_var", (0.052, 0.050, 0.051)),
            ("extra_rescale", (1.1, 0.9, 1.05)))


@pytest.mark.parametrize("name,kw", [
    ("efficientnetv2b0", EXTERNAL),
    ("efficientnetv2b3", EXTERNAL),
    ("efficientnetv2bs", EXTERNAL),
    ("efficientnetv2bm", EXTERNAL),
    ("efficientnetb0", EXTERNAL),
    ("efficientnetb1", EXTERNAL),
    ("efficientnetb5", EXTERNAL),
    # a weight import's per-channel constants (rescale, mean / var, the
    # extra 1/sqrt(std) rescale)
    ("efficientnetb0", dict(EXTERNAL, backbone_args=IMAGENET)),
    # no baked preprocessing, the MagTransform frontend
    ("efficientnetv2b0", dict(use_pcen=False,
                              backbone_args=(("preprocess", False),))),
])
def test_efficientnet_logits_match_flax(name, kw):
    pair, _ = check_family(name, (2, 33, 47, 3), kw)
    assert pair.port.dense.weight.shape[1] == pair.port.backbone.out_channels


@pytest.fixture(scope="module")
def b3_imagenet():
    """B3 at the production geometry on a 3-channel PCEN-like image."""
    pair = Pair("efficientnetv2b3", PRODUCTION, jax_kw=EXTERNAL)
    inputs = inputs_for(pair, PRODUCTION, 1)
    return pair.calibrate(inputs), inputs


def test_b3_production_geometry_imagenet_branch(b3_imagenet):
    pair, inputs = b3_imagenet
    assert pair.port.dense.weight.shape == (7, 1536)
    got, want = pair.logits(inputs)
    assert rel(got, want) < F32_REL
    assert rel(want[0], want[1]) > 100 * F32_REL


def test_b3_production_geometry_gray_branch():
    """1-channel mel power through the model's own PCEN layer: the
    ``x / 128 - 1`` branch (the ImageNet constants need 3 channels)."""
    pair, _ = check_family("efficientnetv2b3", (2, 160, 513, 1),
                           {"use_pcen": True})
    assert pair.port.backbone.stem.weight.shape == (40, 1, 3, 3)


@pytest.mark.parametrize("probabilities", [False, True])
def test_b3_slice_matches_jax(b3_imagenet, probabilities):
    """waveform -> featurizer -> PCEN -> 3-channel repeat ->
    BackboneClassifier(efficientnetv2b3, external_frontend=True), the
    production geometry, B=1, f32."""
    pair, _ = b3_imagenet
    cfg = FeaturizerConfig()
    raw = np.random.default_rng(17).uniform(
        -1.0, 1.0, (1, cfg.samples_per_clip)).astype(np.float32)
    want = np.asarray(jax_infer_fn(
        pair.jax.module, pair.variables, JaxConfig(), use_pcen=True,
        use_pallas=False, channels=3, probabilities=probabilities)(
            jnp.asarray(raw)))
    got = make_fused_infer_fn(pair.port, cfg, use_pcen=True, channels=3,
                              probabilities=probabilities, device="cpu")(raw)
    assert got.shape == want.shape == (1, 7)
    assert rel(got, want) < F32_REL


def test_fold_gray_stem_refuses_per_channel_constants():
    """JAX's cases (tests/test_models.py): per-channel normalization, and
    EfficientNetV2 with its baked preprocessing, with JAX's messages."""
    spec = build_model("efficientnetb0", 3, external_frontend=True,
                       backbone_args=IMAGENET[:2])
    with pytest.raises(ValueError, match="per-channel norm_mean"):
        fold_gray_stem(spec.module)
    for name in ("efficientnetv2b0", "efficientnetv2b3"):
        with pytest.raises(ValueError, match="EfficientNetV2"):
            fold_gray_stem(build_model(name, 3, external_frontend=True).module)
    jax_spec = jax_build_model("efficientnetv2b0", 3, external_frontend=True)
    with pytest.raises(ValueError, match="EfficientNetV2"):
        jax_fold_gray_stem(jax_spec, {"params": {}})


def test_fold_gray_stem_without_preprocessing_matches_jax():
    kw = dict(EXTERNAL, backbone_args=(("preprocess", False),))
    pair = Pair("efficientnetv2b0", (2, 33, 47, 3), jax_kw=kw)
    pair.calibrate(inputs_for(pair, (2, 33, 47, 3), 1))
    gray = inputs_for(pair, (2, 33, 47, 1), 3)[0]
    folded_v = jax_fold_gray_stem(pair.jax, pair.variables)
    want = np.asarray(pair.jax.module.apply(folded_v, jnp.asarray(gray)))
    folded = fold_gray_stem(pair.port)
    assert folded.backbone.stem.weight.shape == (32, 1, 3, 3)
    with torch.no_grad():
        got = folded(torch.from_numpy(gray)).numpy()
        repeat = pair.port(torch.from_numpy(np.repeat(gray, 3, -1))).numpy()
    assert rel(got, want) < F32_REL
    assert rel(got, repeat) < F32_REL


def test_train_mode_matches_flax():
    """BatchNorm on batch moments and Flax's running-statistics update,
    dropout off: logits and every updated statistic.  The Flax side runs
    in float64: the port's stem folds the baked preprocessing into its
    conv (``backbones.folded_stem``), so its f32 logits sit within 2e-5 of
    the exact ones, while Flax's f32 batch variance of the stem's output
    (a constant part about 123 times the signal) carries 9e-5 of its own
    round-off."""
    shape = (2, 33, 47, 3)
    kw = dict(EXTERNAL, dropout=0.0)
    pair = Pair("efficientnetv2b0", shape, jax_kw=kw)
    x = inputs_for(pair, shape, 1)
    pair.calibrate(x)
    with jax.enable_x64():
        want, upd = pair.jax.module.apply(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   pair.variables),
            jnp.asarray(x[0], jnp.float64), train=True,
            mutable=["batch_stats"])
        want = np.asarray(want)
        assert want.dtype == np.float64
    model = pair.port.train()
    got = model(torch.from_numpy(x[0])).detach().numpy()
    assert rel(got, want) < F32_REL
    sd = model.state_dict()
    stats = dict(jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0])
    n = 0
    for path, (key, _) in flax_leaf_map(model).items():
        if path[0] != "batch_stats":
            continue
        jpath = tuple(jax.tree_util.DictKey(p) for p in path[1:])
        np.testing.assert_allclose(sd[key].numpy(), np.asarray(stats[jpath]),
                                   rtol=1e-5, atol=1e-6)
        n += 1
    assert n == len(stats)


def test_converter_refuses_other_trees():
    """A tree of another variant, of another frontend mode, with a missing
    or a stray (empty) scope, or of other shapes is refused."""
    b0 = Pair("efficientnetv2b0", (1, 33, 47, 3), jax_kw=EXTERNAL)
    b3 = build_model("efficientnetv2b3", 7, external_frontend=True).module
    with pytest.raises(ValueError, match="not a BackboneClassifier"):
        state_dict_from_flax(b3, b0.variables)
    pcen = build_model("efficientnetv2b0", 7).module
    with pytest.raises(ValueError, match="missing .*PCENLayer_0"):
        state_dict_from_flax(pcen, b0.variables)
    v = b0.variables
    params = dict(v["params"], Dense_1={})
    with pytest.raises(ValueError, match="unexpected .*Dense_1"):
        state_dict_from_flax(b0.port, dict(v, params=params))
    net = dict(v["params"]["EfficientNetV2_0"])
    del net["MBConv_10"]
    with pytest.raises(ValueError, match="missing .*MBConv_10"):
        state_dict_from_flax(b0.port, dict(v, params=dict(
            v["params"], EfficientNetV2_0=net)))
    other = build_model("efficientnetv2b0", 9, external_frontend=True).module
    with pytest.raises(ValueError, match="of these shapes"):
        state_dict_from_flax(other, v)
