"""badwinner2 of the port against the Flax model on converted weights.

The Flax variables are initialised by ``build_model`` and then randomized
from a numpy seed (BN statistics with positive variance, BN scale and bias,
the MagTransform power) so that no BatchNorm is the identity.  f32 logits
agree to 1e-4 of max |logit| (both sides run exact f32 convolutions on the
CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu_torch.models import BadWinner2, build_model
from audio_training_tpu_torch.models.convert import (
    badwinner2_state_dict_from_flax,
)

torch.set_num_threads(2)

F32_REL = 1e-4
# bf16 keeps 8 mantissa bits (a step of 2^-8 = 3.9e-3 relative); Flax and
# torch round activations at different places through eight conv layers,
# so the bf16 logits agree to a few bf16 steps of max |logit| only.
BF16_REL = 3e-2
NUM_LABELS = 7


def flax_variables(shape, dtype=None, seed=0, num_labels=NUM_LABELS):
    """Flax badwinner2 (module, variables) with randomized BN and frontend."""
    spec = jax_build_model("badwinner2", num_labels, logits_only=True,
                           dtype=dtype)
    init = spec.module.init({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros(shape), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), init)
    rng = np.random.default_rng(seed + 100)
    for mod in v["batch_stats"].values():
        n = mod["BatchNorm_0"]["mean"].shape[0]
        mod["BatchNorm_0"]["mean"] = rng.normal(0.0, 0.2, n).astype(np.float32)
        mod["BatchNorm_0"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    for name, mod in v["params"].items():
        if name.startswith("KerasBatchNorm"):
            n = mod["BatchNorm_0"]["scale"].shape[0]
            mod["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, n).astype(
                np.float32)
            mod["BatchNorm_0"]["bias"] = rng.normal(0.0, 0.1, n).astype(
                np.float32)
    v["params"]["MagTransform_0"]["a_power"] = np.array([-0.6], np.float32)
    return spec.module, v


def port_model(variables, n_mels, dtype=None, **kw):
    model = build_model("badwinner2", NUM_LABELS, logits_only=True,
                        dtype=dtype, n_mels=n_mels, **kw).module
    model.load_state_dict(badwinner2_state_dict_from_flax(variables))
    return model.eval()


def mel_like(shape, seed):
    return np.random.default_rng(seed).gamma(2.0, 50.0, shape).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 96, 243, 1), (1, 160, 513, 1)])
def test_f32_logits_match_flax(shape):
    module, v = flax_variables(shape)
    x = mel_like(shape, 1)
    want = module.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(v, shape[1])(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) < F32_REL


def test_bf16_logits_match_flax_bf16():
    shape = (2, 96, 243, 1)
    module, v = flax_variables(shape, dtype=jnp.bfloat16)
    x = mel_like(shape, 2)
    want = module.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(v, 96, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) < BF16_REL


@pytest.mark.parametrize("kw", [{"lme": True}, {"multi_label": False}])
def test_head_options_match_flax(kw):
    """LME pooling over mel then time; the softmax head."""
    shape = (2, 96, 243, 1)
    spec = jax_build_model("badwinner2", NUM_LABELS, **kw)
    _, v = flax_variables(shape)
    x = mel_like(shape, 3)
    want = spec.module.apply(v, jnp.asarray(x), train=False)
    model = build_model("badwinner2", NUM_LABELS, n_mels=96, **kw).module
    model.load_state_dict(badwinner2_state_dict_from_flax(v))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert _rel(got, want) < F32_REL


def test_conversion_round_trip_of_shapes():
    shape = (1, 160, 513, 1)
    _, v = flax_variables(shape)
    sd = badwinner2_state_dict_from_flax(v)
    model = BadWinner2(NUM_LABELS)
    own = model.state_dict()
    assert sd.keys() == own.keys()
    for k in own:
        assert sd[k].shape == own[k].shape, k
    # HWIO -> OIHW: element [o, i, h, w] is Flax kernel[h, w, i, o]
    kernel = v["params"]["Conv_4"]["Conv_0"]["kernel"]
    assert kernel.shape == (44, 3, 128, 128)
    assert sd["convs.4.weight"][5, 7, 40, 2] == kernel[40, 2, 7, 5]
    np.testing.assert_array_equal(
        sd["mel_bn.running_var"],
        v["batch_stats"]["KerasBatchNorm_0"]["BatchNorm_0"]["var"])
    bad = {"params": dict(v["params"], Conv_8={}), "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="not a badwinner2"):
        badwinner2_state_dict_from_flax(bad)


def test_model_guards():
    with pytest.raises(ValueError, match="Unhandled mel channels"):
        BadWinner2(NUM_LABELS, n_mels=128)
    model = BadWinner2(NUM_LABELS, n_mels=96)
    # training mode runs (batch moments, dropout): a module is built in it
    assert model.training
    probs = model(torch.rand(2, 96, 243, 1),
                  generator=torch.Generator().manual_seed(0))
    assert probs.shape == (2, NUM_LABELS) and bool(torch.isfinite(probs).all())
    with pytest.raises(ValueError, match="96 mel rows"):
        model.eval()(torch.zeros(1, 160, 513, 1))
    # mobilenet is ported (tests/test_torch_backbones.py); the reference's
    # default backbone and the other families are not
    assert build_model("mobilenet", NUM_LABELS).inputs == ("mel",)
    for name in ("efficientnetv2b3", "wr-resnet"):
        with pytest.raises(NotImplementedError, match="Model families"):
            build_model(name, NUM_LABELS)


def test_generator_seeds_the_weights():
    def weights(seed):
        g = torch.Generator().manual_seed(seed)
        return BadWinner2(NUM_LABELS, n_mels=96, generator=g).state_dict()

    a, b, c = weights(0), weights(0), weights(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])
