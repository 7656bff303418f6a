"""K1's folds, its centered tensor-core tiers and badwinner2's external
frontend of the port, against the JAX package on the CPU.

The folds put badwinner2's whole pre-CNN chain into the featurizer:
``normalize_waveform`` (the per-clip min-max of ``normalize_rows``, zeros past
the clip staying zero in normalized space) and ``frontend_params = (a_power,
bn_mean, bn_var)`` (MagTransform and the per-mel-row BatchNorm on the mel).
On the CPU the port's ``FusedFeaturizer`` computes their plain versions; they
are held against the JAX class's folds in interpret mode at rtol/atol 2e-4
(tests/test_fused_featurizer.py:245-274), at the "highest" tier, and at the
"default" / "bf16_3x" tiers in each tier's own class (tests/
test_torch_train_featurizer.py, tests/test_torch_ladder.py).  The folded
chain (K1 with both folds -> ``BadWinner2(external_frontend=True)``) is held
against JAX's composition at 1e-4 of max |logit|.  The CUDA kernels run only
on a card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu.ops.fftmel import MatmulMelPlan
from audio_training_tpu.ops.pallas.fused_featurizer import (
    FusedFeaturizer as JaxFusedFeaturizer,
)
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.models import BadWinner2, build_model
from audio_training_tpu_torch.models.convert import (
    badwinner2_frontend_params_from_flax,
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights, normalize_rows
from audio_training_tpu_torch.ops.pcen import pcen

from test_torch_badwinner2 import flax_variables, mel_like

torch.set_num_threads(2)

FOLD_TOL = 2e-4  # rtol and atol, as tests/test_fused_featurizer.py:274
PCEN_ABS = 1e-4
MEL_REL = 1e-5
# the tiers' own classes against the exact mel: one bf16 pass ("default"),
# three passes ("bf16_3x")
TIER_REL = {"default": 1e-2, "bf16_3x": 2e-5}
LOGIT_REL = 1e-4
SHORT = 24000  # 0.5 s keeps the JAX interpret-mode kernel cheap
CHAIN = 36000  # 129 frames: the shortest clips badwinner2's stack takes
NUM_LABELS = 7


@pytest.fixture(scope="module")
def mel_w():
    return build_mel_weights(FeaturizerConfig())


def _clips(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(
        np.float32)


def _frontend_params(seed=11, n_mels=160):
    rng = np.random.default_rng(seed)
    return (np.array([-0.7], np.float32),
            rng.normal(0.5, 0.2, n_mels).astype(np.float32),
            rng.uniform(0.5, 2.0, n_mels).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


FOLDS = {"normalize": dict(normalize_waveform=True),
         "frontend": dict(frontend_params=_frontend_params()),
         "both": dict(normalize_waveform=True,
                      frontend_params=_frontend_params())}


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_folds_match_jax_kernel_interpret(mel_w, fold):
    raw = _clips(2, SHORT, 1)
    kw = FOLDS[fold]
    want = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw), pcen=False, interpret=True,
        **{k: (tuple(jnp.asarray(v) for v in a) if k == "frontend_params"
               else a) for k, a in kw.items()})
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False, **kw)
    assert got.shape == (2, 160, -(-SHORT // 281))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FOLD_TOL,
                               atol=FOLD_TOL)


def test_normalize_fold_with_pcen_matches_jax_kernel_interpret(mel_w):
    """The normalize fold also runs in front of the PCEN epilogue."""
    raw = 0.3 * _clips(2, SHORT, 2) + 0.1  # not already in [-1, 1]
    want = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw), pcen=True, normalize_waveform=True, interpret=True)
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    got = fz(torch.from_numpy(raw), pcen=True, normalize_waveform=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() < PCEN_ABS


def test_fold_plain_versions_are_the_unfused_composition(mel_w):
    """The plain version is ``normalize_rows`` -> the tier's plain mel ->
    ``exp(g log(max(mel, 1e-30))) s + b``, and the frontend's affine is
    MagTransform's power and the Keras BatchNorm's scale (eps 1e-3)."""
    raw = torch.from_numpy(_clips(2, SHORT, 3))
    a, mean, var = _frontend_params()
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    g, stats = ffz.frontend_tables((a, mean, var), 160, "cpu")
    assert g == pytest.approx(1.0 / (1.0 + np.exp(0.7)), rel=1e-6)
    np.testing.assert_allclose(stats[:, 0], 1.0 / np.sqrt(var + 1e-3),
                               rtol=1e-6)
    np.testing.assert_allclose(stats[:, 1], -mean / np.sqrt(var + 1e-3),
                               rtol=1e-6)
    mel = ffz.fused_featurizer_plain(normalize_rows(raw), fz.mel_weights, 281)
    want = torch.exp(g * torch.log(mel.clamp_min(1e-30))) * stats[:, :1] \
        + stats[:, 1:]
    got = fz(raw, pcen=False, normalize_waveform=True,
             frontend_params=(a, mean, var))
    assert torch.equal(got, want)
    # the frontend of the unfused model: x ** sigmoid(a), then (x - mean) s
    unfused = (mel ** g - torch.from_numpy(mean)[:, None]) \
        * torch.rsqrt(torch.from_numpy(var)[:, None] + 1e-3)
    assert _rel(got, unfused) < 1e-5
    # a clipped power: a_power beyond [-2, 1] acts as the bound
    assert ffz.frontend_tables((np.float32(5.0), mean, var), 160, "cpu")[0] \
        == ffz.frontend_tables((np.float32(1.0), mean, var), 160, "cpu")[0]
    # bf16 output is the cast of the f32 output
    b16 = fz(raw, pcen=False, normalize_waveform=True,
             frontend_params=(a, mean, var), out_dtype=torch.bfloat16)
    assert torch.equal(b16, got.to(torch.bfloat16))


def test_normalize_fold_keeps_the_tail_zero_in_normalized_space(mel_w):
    """tf pad_end pads the normalized clip with zeros: the last frame, most
    of it past the clip, sees the clip's normalized tail and zeros, not the
    normalized value of a zero sample (-1 for a clip whose min is 0)."""
    raw = np.abs(_clips(1, 5000, 4)) + 0.5  # min > 0: a raw 0 maps below -1
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False, normalize_waveform=True)
    norm = normalize_rows(torch.from_numpy(raw))
    assert torch.equal(got, fz(norm, pcen=False))
    want = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw), pcen=False, normalize_waveform=True, interpret=True)
    assert _rel(got, want) < MEL_REL


def test_clip_minmax_plain_is_what_normalize_rows_divides_by():
    raw = torch.from_numpy(_clips(3, 1001, 5))
    mm = ffz.clip_minmax(raw)
    assert mm.shape == (3, 2) and mm.dtype == torch.float32
    shifted = raw - raw.amin(-1, keepdim=True)
    assert torch.equal(mm[:, 0], raw.amin(-1))
    assert torch.equal(mm[:, 1], shifted.amax(-1))
    # normalize_rows' own operations on (min, range) give its output bitwise
    u = (raw - mm[:, :1]) / mm[:, 1:] + 1e-6
    assert torch.equal((u - 0.5) * 2.0, normalize_rows(raw))
    with pytest.raises(ValueError, match="float32"):
        ffz.clip_minmax(raw.double())


def test_constant_clip_is_nan_as_in_jax(mel_w):
    """max == min divides 0 by 0 in normalize_rows and in the JAX kernel
    alike; the port adds no guard."""
    raw = np.full((1, SHORT), 0.25, np.float32)
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False, normalize_waveform=True)
    want = np.asarray(JaxFusedFeaturizer(mel_w, 4096, 281)(
        jnp.asarray(raw), pcen=False, normalize_waveform=True, interpret=True))
    assert np.isnan(want).any()
    assert torch.isnan(got).any()


@pytest.mark.parametrize("tier", ["default", "bf16_3x"])
def test_folded_tiers_match_jax_folds_in_their_class(mel_w, tier):
    raw = _clips(2, SHORT, 6)
    fp = _frontend_params()
    want = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")(
        jnp.asarray(raw), pcen=False, normalize_waveform=True,
        frontend_params=tuple(jnp.asarray(v) for v in fp), interpret=True)
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision=tier, device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False, normalize_waveform=True,
             frontend_params=fp)
    assert _rel(got, want) < TIER_REL[tier]
    # the plain version is the tier's plain mel of normalize_rows' clips
    norm = normalize_rows(torch.from_numpy(raw))
    mel = (ffz.mel_power_bf16 if tier == "default" else ffz.mel_power_bf16_3x)(
        norm, fz.mel_weights, 281)
    assert torch.equal(fz(torch.from_numpy(raw), pcen=False,
                          normalize_waveform=True), mel)
    assert torch.equal(got, ffz.frontend_plain(
        mel, *ffz.frontend_tables(fp, 160, "cpu")))


# 144,000 samples: 513 frames in both framings; 28,100 = 100 hops: 100 tf
# frames, 101 centered ones
@pytest.mark.parametrize("tier,samples", [
    ("default", 144000), ("default", 28100),
    ("bf16_3x", 144000), ("bf16_3x", 28100)])
def test_centered_tiers_match_jax_centered_mel(mel_w, tier, samples):
    raw = _clips(1, samples, 7)
    want = MatmulMelPlan(mel_w, 4096, 281, center=True, precision="highest")(
        jnp.asarray(raw))
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, precision=tier, center=True,
                             device="cpu")
    got = fz(torch.from_numpy(raw), pcen=False)
    assert got.shape == (1, 160, 1 + samples // 281)
    assert _rel(got, want) < TIER_REL[tier]
    plain = ffz.mel_power_bf16 if tier == "default" else ffz.mel_power_bf16_3x
    assert torch.equal(got, plain(torch.from_numpy(raw), fz.mel_weights, 281,
                                  center=True))
    # centered PCEN runs on the tier's own mel; the three-pass tier's stays
    # in the exact tier's PCEN class
    short = torch.from_numpy(raw[:, :SHORT])
    got_pcen = fz(short, pcen=True, normalize=False)
    assert torch.equal(got_pcen, pcen(plain(short, fz.mel_weights, 281,
                                            center=True),
                                      *fz.pcen_params, time_axis=2,
                                      normalize=False))
    if tier == "bf16_3x":
        want_pcen = JaxFusedFeaturizer(mel_w, 4096, 281, center=True)(
            jnp.asarray(raw[:, :SHORT]), pcen=True, interpret=True)
        assert np.abs(fz(short, pcen=True).numpy()
                      - np.asarray(want_pcen)).max() < PCEN_ABS


def test_centered_framing_is_the_padded_tf_framing(mel_w):
    """The centered tiers frame the clip padded by 2048 zeros on both
    sides: the tf framing of that padded clip, cut to 1 + n // hop frames."""
    raw = torch.from_numpy(_clips(1, 28100, 8))
    padded = torch.nn.functional.pad(raw, (2048, 2048))
    for plain in (ffz.mel_power_bf16, ffz.mel_power_bf16_3x):
        got = plain(raw, torch.from_numpy(mel_w), 281, center=True)
        want = plain(padded, torch.from_numpy(mel_w), 281)[..., :101]
        assert torch.equal(got, want)


def test_jax_contracts_raise(mel_w):
    """The ValueErrors left are the JAX class's own: a fold with center=True,
    the frontend with PCEN, and malformed frontend parameters."""
    raw = np.zeros((1, SHORT), np.float32)
    fp = _frontend_params()
    for precision in ffz.PRECISIONS:
        fz_c = ffz.FusedFeaturizer(mel_w, precision=precision, center=True,
                                   device="cpu")
        jfz_c = JaxFusedFeaturizer(mel_w, center=True)
        for kw in (dict(normalize_waveform=True), dict(frontend_params=fp)):
            with pytest.raises(ValueError, match="centered"):
                jfz_c(jnp.asarray(raw), pcen=False, **kw)
            with pytest.raises(ValueError, match="centered"):
                fz_c(torch.from_numpy(raw), pcen=False, **kw)
        fz = ffz.FusedFeaturizer(mel_w, precision=precision, device="cpu")
        with pytest.raises(ValueError, match="frontend"):
            JaxFusedFeaturizer(mel_w)(jnp.asarray(raw), pcen=True,
                                      frontend_params=fp)
        with pytest.raises(ValueError, match="frontend"):
            fz(torch.from_numpy(raw), pcen=True, frontend_params=fp)
    with pytest.raises(ValueError, match="frontend_params must be"):
        ffz.FusedFeaturizer(mel_w, device="cpu")(
            torch.from_numpy(raw), pcen=False, frontend_params=fp[:1] * 3)


def test_fold_launch_counters(mel_w):
    """On a card a folded launch counts as its tier's "_folded" mel kernel
    and a centered one as its "_centered" kernel (the CPU path counts
    nothing)."""
    assert ffz.mel_counter("highest", folded=True) == "fused_featurizer_mel_folded"
    assert ffz.mel_counter("default", center=True) == (
        "fused_featurizer_mel_bf16_centered")
    assert ffz.mel_counter("bf16_3x_manual", folded=True) == (
        "fused_featurizer_mel_bf16x3_folded")
    counts = ffz.launch_counts()
    for tier in ffz.PRECISIONS:
        for kw in ({}, {"center": True}, {"folded": True}):
            assert ffz.mel_counter(tier, **kw) in counts
    assert "clip_minmax" in counts
    ffz.reset_launch_counts()
    ffz.FusedFeaturizer(mel_w, device="cpu")(
        torch.from_numpy(_clips(1, SHORT, 9)), pcen=False,
        normalize_waveform=True)
    assert not any(ffz.launch_counts().values())


# ---- badwinner2 with an external frontend --------------------------------


def _external_flax(shape, seed=0):
    """Flax BadWinner2(external_frontend=True) (module, variables) with
    randomized BatchNorms."""
    spec = jax_build_model("badwinner2", NUM_LABELS, logits_only=True,
                           external_frontend=True)
    init = spec.module.init({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros(shape), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), init)
    rng = np.random.default_rng(seed + 100)
    for name, mod in v["batch_stats"].items():
        n = mod["BatchNorm_0"]["mean"].shape[0]
        mod["BatchNorm_0"]["mean"] = rng.normal(0.0, 0.2, n).astype(np.float32)
        mod["BatchNorm_0"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        p = v["params"][name]["BatchNorm_0"]
        p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        p["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    return spec.module, v


@pytest.mark.parametrize("n_mels,frames", [(96, 243), (160, 513)])
def test_external_frontend_logits_match_flax(n_mels, frames):
    shape = (1, n_mels, frames, 1)
    module, v = _external_flax(shape)
    assert "KerasBatchNorm_6" in v["params"] and "MagTransform_0" not in v["params"]
    x = np.random.default_rng(1).normal(0.0, 1.0, shape).astype(np.float32)
    want = module.apply(v, jnp.asarray(x), train=False)
    model = build_model("badwinner2", NUM_LABELS, logits_only=True,
                        n_mels=n_mels, external_frontend=True).module
    assert model.mag is None and model.mel_bn is None
    model.load_state_dict(badwinner2_state_dict_from_flax(
        v, external_frontend=True))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert _rel(got, want) < LOGIT_REL


def test_converter_refuses_the_other_tree():
    shape = (1, 96, 243, 1)
    _, ext = _external_flax(shape)
    _, own = flax_variables(shape)
    with pytest.raises(ValueError, match="external frontend"):
        badwinner2_state_dict_from_flax(own, external_frontend=True)
    with pytest.raises(ValueError, match="own frontend"):
        badwinner2_state_dict_from_flax(ext)
    with pytest.raises(ValueError, match="own frontend"):
        badwinner2_frontend_params_from_flax(ext)
    a, mean, var = badwinner2_frontend_params_from_flax(own)
    np.testing.assert_array_equal(a, own["params"]["MagTransform_0"]["a_power"])
    stats = own["batch_stats"]["KerasBatchNorm_0"]["BatchNorm_0"]
    np.testing.assert_array_equal(mean, stats["mean"])
    np.testing.assert_array_equal(var, stats["var"])
    # the converted keys are the external model's own
    sd = badwinner2_state_dict_from_flax(ext, external_frontend=True)
    assert sd.keys() == BadWinner2(NUM_LABELS, n_mels=96,
                                   external_frontend=True).state_dict().keys()
    np.testing.assert_array_equal(
        sd["bns.0.running_var"],
        ext["batch_stats"]["KerasBatchNorm_0"]["BatchNorm_0"]["var"])


def test_folded_chain_matches_jax_composition_and_the_unfused_chain(mel_w):
    """Interpret K1 with both folds -> Flax BadWinner2(external_frontend=
    True), against the port's folded chain: f32 logits within 1e-4 of max
    |logit|.  The port's unfused chain (normalize_rows -> K1 -> BadWinner2
    with its own frontend, the same weights) agrees to the same bound."""
    raw = 0.5 * _clips(2, CHAIN, 10)
    shape = (1, 160, -(-CHAIN // 281), 1)
    module, v = _external_flax(shape, seed=1)
    # the frontend statistics of the unfused model, calibrated to the
    # image so that the BatchNorm is not far from centring it
    _, own = flax_variables(shape, seed=1)
    fz = ffz.FusedFeaturizer(mel_w, 4096, 281, device="cpu")
    mel = fz(torch.from_numpy(raw), pcen=False, normalize_waveform=True)
    g = 1.0 / (1.0 + np.exp(0.6))  # the helper's a_power, -0.6
    rows = (mel.numpy() ** g).transpose(1, 0, 2).reshape(160, -1)
    stats = own["batch_stats"]["KerasBatchNorm_0"]["BatchNorm_0"]
    rng = np.random.default_rng(12)
    stats["mean"] = (rows.mean(1) * rng.uniform(0.8, 1.2, 160)).astype(np.float32)
    stats["var"] = (rows.var(1) * rng.uniform(0.5, 2.0, 160)).astype(np.float32)
    fp = badwinner2_frontend_params_from_flax(own)

    jfz = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")
    img = jfz(jnp.asarray(raw), pcen=False, normalize_waveform=True,
              frontend_params=tuple(jnp.asarray(a) for a in fp),
              interpret=True)[..., None]
    want = np.asarray(module.apply(v, img, train=False))

    folded = build_model("badwinner2", NUM_LABELS, logits_only=True,
                         external_frontend=True).module
    folded.load_state_dict(badwinner2_state_dict_from_flax(
        v, external_frontend=True))
    with torch.no_grad():
        got = folded.eval()(fz(torch.from_numpy(raw), pcen=False,
                               normalize_waveform=True,
                               frontend_params=fp)[..., None])
    assert got.shape == (2, NUM_LABELS)
    assert _rel(got, want) < LOGIT_REL
    assert _rel(want[0], want[1]) > 10 * LOGIT_REL  # the logits see the clip

    unfused = build_model("badwinner2", NUM_LABELS, logits_only=True).module
    sd = badwinner2_state_dict_from_flax(v, external_frontend=True)
    sd.update({"mag.a_power": torch.from_numpy(fp[0]),
               "mel_bn.running_mean": torch.from_numpy(fp[1]),
               "mel_bn.running_var": torch.from_numpy(fp[2])})
    unfused.load_state_dict(sd)
    with torch.no_grad():
        ref = unfused.eval()(fz(normalize_rows(torch.from_numpy(raw)),
                                pcen=False)[..., None])
    assert _rel(got, ref) < LOGIT_REL


def test_mel_like_input_keeps_the_unfused_model_running():
    """badwinner2 with its own frontend still takes mel power (the helper
    of tests/test_torch_badwinner2.py), and its state dict still carries
    the frontend."""
    model = BadWinner2(NUM_LABELS, n_mels=96).eval()
    assert {"mag.a_power", "mel_bn.running_mean"} <= model.state_dict().keys()
    with torch.no_grad():
        out = model(torch.from_numpy(mel_like((1, 96, 243, 1), 2)))
    assert out.shape == (1, NUM_LABELS) and bool(torch.isfinite(out).all())
