"""The rest of training's ops and preprocess against the JAX package's, on
the CPU: the normalizers, the centered magnitude mel, dual-badwinner2's two
band-limited views (K2's function on the band-masked bank), the multi-scale
mel, SpecAugment, the STFTs' ``window`` / ``pad_mode``, the ``matmul``
backend name, ``ops.__all__``, and ``make_preprocess_fn(dual=True)`` /
``use_spec_augment`` / ``make_merge_preprocess_fn``.

Tolerances: mel images 1e-5 global relative (f32, the two packages' FFTs
and sums in another order); the normalizers 1e-6; SpecAugment's apply
bitwise (a select). JAX keys and torch generators draw different bits, so
SpecAugment's apply takes JAX's own draws, the port's draws are held to
JAX's limits, and the augmented merge batch is held to JAX's functions
applied with the port's mix weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu import ops as jops
from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.data import preprocess as jpre
from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu.ops import featurizer_select as jselect
from audio_training_tpu.ops import features as jfeatures
from audio_training_tpu.ops import stft as jstft
from audio_training_tpu_torch import ops
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.data import preprocess as pre
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import state_dict_from_flax
from audio_training_tpu_torch.ops import features, stft
from audio_training_tpu_torch.ops.cuda import melspec
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn

torch.set_num_threads(2)

REL = 1e-5
NORM_REL = 1e-6
SMALL = dict(sr=8000, n_fft=512, hop_length=100, n_mels=96, fmin=100.0,
             fmax=3500.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _clips(batch, samples, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, samples)).astype(np.float32)


def test_power_to_db_and_normalize_std_match_jax():
    mel = np.random.default_rng(0).gamma(0.5, 2.0, (2, 40, 30)).astype(
        np.float32)
    mel[0, :3] = 0.0  # the amin floor
    assert _rel(features.power_to_db(torch.from_numpy(mel)),
                jfeatures.power_to_db(jnp.asarray(mel))) < NORM_REL
    assert _rel(features.normalize_std(torch.from_numpy(mel)),
                jfeatures.normalize_std(jnp.asarray(mel))) < NORM_REL


@pytest.mark.parametrize("power", [1, 2])
def test_mel_from_waveform_centered_matches_jax(power):
    cfg = FeaturizerConfig(**SMALL)
    w = features.build_mel_weights(cfg)
    raw = _clips(2, 8000, 1)
    got = features.mel_from_waveform_centered(
        torch.from_numpy(raw), torch.from_numpy(w), 512, 100, power)
    want = jfeatures.mel_from_waveform_centered(
        jnp.asarray(raw), jnp.asarray(w), 512, 100, power)
    assert got.shape == (2, 96, 81)
    assert _rel(got, want) < REL


def _dual_weights(cfg):
    return [features.build_mel_weights(c) for c in pre.dual_configs(cfg)]


def test_raw_to_mel_dual_matches_jax_at_production_geometry():
    cfg = FeaturizerConfig()
    cfg_a, cfg_b = pre.dual_configs(cfg)
    assert (cfg_a.n_fft, cfg_a.hop_length, cfg_a.fmin, cfg_a.fmax) == (
        2048, 278, 100.0, 3000.0)
    assert (cfg_b.n_fft, cfg_b.hop_length, cfg_b.fmin, cfg_b.fmax) == (
        1024, 280, 500.0, 11000.0)
    w_a, w_b = _dual_weights(cfg)
    kw = dict(sr=cfg.sr, params_a=(2048, 278), params_b=(1024, 280),
              band_a=(cfg_a.fmin, cfg_a.fmax), band_b=(cfg_b.fmin, cfg_b.fmax))
    raw = _clips(2, cfg.samples_per_clip, 2)
    got = features.raw_to_mel_dual(torch.from_numpy(raw), w_a, w_b, **kw)
    want = jfeatures.raw_to_mel_dual(jnp.asarray(raw), jnp.asarray(w_a),
                                     jnp.asarray(w_b), **kw)
    assert got[0].shape == (2, 160, 518, 1) and got[1].shape == (2, 160, 515, 1)
    for g, w in zip(got, want):
        assert _rel(g, w) < REL


def test_dual_banks_fit_k2():
    """The masked banks are the bank with the out-of-band bins zeroed, and
    their band walks span the support K2 stages (about 130 and 230 bins
    at the production geometry), so the card runs the kernel."""
    cfg = FeaturizerConfig()
    dual = pre.make_dual_mel(cfg, device="cpu")
    supports = []
    for (bank_t, n_fft, _), w, c in zip(dual.views, _dual_weights(cfg),
                                        pre.dual_configs(cfg)):
        freqs = np.arange(n_fft // 2 + 1) * cfg.sr / n_fft
        inside = (freqs >= c.fmin) & (freqs <= c.fmax)
        bank = bank_t.numpy()
        np.testing.assert_array_equal(bank[inside], w.T[inside])
        assert not bank[~inside].any()
        plan = melspec.band_walk_plan(bank)
        assert plan.support <= melspec.MAX_SUPPORT
        supports.append(plan.support)
    assert 120 < supports[0] < 140 and 215 < supports[1] < 240, supports


def test_raw_to_mel_multi_matches_jax():
    cfg = FeaturizerConfig(**SMALL)
    params = [(512, 100), (256, 100)]
    ws = [features.build_mel_weights(FeaturizerConfig(**{**SMALL,
                                                         "n_fft": n}))
          for n, _ in params]
    raw = _clips(2, 8000, 3)
    got = features.raw_to_mel_multi(torch.from_numpy(raw),
                                    [torch.from_numpy(w) for w in ws], params)
    want = jfeatures.raw_to_mel_multi(jnp.asarray(raw),
                                      [jnp.asarray(w) for w in ws], params)
    assert got.shape == (2, cfg.n_mels, 80, 2)
    assert _rel(got, want) < REL


def _jax_draws(key, b, n_mels, frames):
    """JAX spec_augment's own draws (ops/features.py:281-291)."""
    keys = jax.random.split(key, 4)

    def draw(k, size, width, count):
        starts = jax.random.randint(k, (b, count, 1), 0,
                                    max(size - width, 1))
        widths = jax.random.randint(jax.random.fold_in(k, 1), (b, count, 1),
                                    0, width + 1)
        return (torch.from_numpy(np.asarray(starts)[..., 0].astype(np.int64)),
                torch.from_numpy(np.asarray(widths)[..., 0].astype(np.int64)))

    return features.SpecAugmentDraw(*draw(keys[0], frames, 50, 2),
                                    *draw(keys[1], n_mels, 20, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_apply_is_bitwise_jax_given_its_draws(seed):
    mel = np.random.default_rng(seed).standard_normal(
        (3, 40, 120, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    draw = _jax_draws(key, 3, 40, 120)
    got = features.apply_spec_augment(torch.from_numpy(mel), draw)
    want = np.asarray(jfeatures.spec_augment(key, jnp.asarray(mel)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_spec_augment_draws_keep_jax_limits():
    gen = torch.Generator().manual_seed(0)
    b, n_mels, frames = 256, 160, 513
    d = features.sample_spec_augment(gen, b, n_mels, frames)
    for starts, widths, size, width in (
            (d.time_starts, d.time_widths, frames, 50),
            (d.freq_starts, d.freq_widths, n_mels, 20)):
        assert starts.shape == widths.shape == (b, 2)
        assert starts.min() >= 0 and starts.max() < max(size - width, 1)
        assert widths.min() == 0 and widths.max() == width
        assert starts.max() >= size - width - 10  # the range is covered
    mel = torch.randn(4, 40, 60, 1)
    out = features.spec_augment(torch.Generator().manual_seed(5), mel)
    again = features.apply_spec_augment(mel, features.sample_spec_augment(
        torch.Generator().manual_seed(5), 4, 40, 60))
    assert torch.equal(out, again)


@pytest.mark.parametrize("pad_mode", ["constant", "reflect", "edge", "wrap"])
@pytest.mark.parametrize("window", [True, False])
def test_stft_window_and_pad_mode_match_jax(pad_mode, window):
    raw = _clips(2, 3000, 4)
    got = stft.stft_centered(torch.from_numpy(raw), 512, 100, window=window,
                             pad_mode=pad_mode)
    want = jstft.stft_centered(jnp.asarray(raw), 512, 100, window=window,
                               pad_mode=pad_mode)
    assert _rel(torch.view_as_real(got.contiguous()),
                np.stack([np.real(want), np.imag(want)], -1)) < REL
    got = stft.stft_tf_style(torch.from_numpy(raw), 512, 100, window=window)
    want = jstft.stft_tf_style(jnp.asarray(raw), 512, 100, window=window)
    assert _rel(torch.view_as_real(got),
                np.stack([np.real(want), np.imag(want)], -1)) < REL


def test_matmul_backend_runs_the_rfft_path():
    cfg = FeaturizerConfig(segment_length=0.75, n_mels=96)
    raw = torch.from_numpy(_clips(1, cfg.samples_per_clip, 5))
    got = make_mel_fn(cfg, backend="matmul", device="cpu")(raw)
    assert torch.equal(got, make_mel_fn(cfg, backend="rfft",
                                        device="cpu")(raw))
    want = jselect.make_mel_fn(JaxConfig(segment_length=0.75, n_mels=96),
                               backend="matmul")(jnp.asarray(raw.numpy()))
    assert _rel(got, want) < REL


def test_ops_exports_the_jax_names_it_has():
    assert set(ops.__all__) <= set(jops.__all__)
    assert set(jops.__all__) - set(ops.__all__) == set()
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


# ---------------------------------------------------------------------------
# make_preprocess_fn(dual=True), use_spec_augment, make_merge_preprocess_fn
# ---------------------------------------------------------------------------


def _labels(batch, seed, n=4):
    return np.eye(n, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, n, batch)]


def test_dual_preprocess_matches_jax_at_production_geometry():
    cfg = FeaturizerConfig()
    raw, raw2 = _clips(2, cfg.samples_per_clip, 6), _clips(
        2, cfg.samples_per_clip, 7)
    y, y2 = _labels(2, 0), _labels(2, 1)
    got, _ = pre.make_preprocess_fn(cfg, dual=True, device="cpu")(raw, y)
    want, _ = jpre.make_preprocess_fn(JaxConfig(), dual=True)(
        jnp.asarray(raw), jnp.asarray(y))
    for g, w in zip(got, want):
        assert _rel(g, w) < REL
    # augmented at mixup_chance 0: every sample is its partner (no draw
    # decides anything), normalized and featurized as the eval path
    got, got_y = pre.make_preprocess_fn(
        cfg, augment=True, mixup_chance=0.0, dual=True, device="cpu")(
        raw, y, raw2, y2, torch.Generator().manual_seed(0))
    want, want_y = jpre.make_preprocess_fn(
        JaxConfig(), augment=True, mixup_chance=0.0, dual=True)(
        jnp.asarray(raw), jnp.asarray(y), jnp.asarray(raw2), jnp.asarray(y2),
        jax.random.PRNGKey(0))
    for g, w in zip(got, want):
        assert _rel(g, w) < REL
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_spec_augment_preprocess_masks_the_mixed_image():
    """The augmented path draws the mix weights, then the masks, from its
    one generator, and masks the image of the mixed clips."""
    cfg = FeaturizerConfig(**SMALL)
    raw, raw2 = _clips(3, cfg.samples_per_clip, 8), _clips(
        3, cfg.samples_per_clip, 9)
    y, y2 = _labels(3, 2), _labels(3, 3)
    got, _ = pre.make_preprocess_fn(cfg, augment=True, use_spec_augment=True,
                                    device="cpu")(
        raw, y, raw2, y2, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    l = features.sample_mix_weights(gen, 3)
    draw = features.sample_spec_augment(gen, 3, cfg.n_mels, cfg.mel_frames)
    mixed = features.apply_mix(l, torch.from_numpy(raw), torch.from_numpy(raw2))
    want = jfeatures.raw_to_mel(
        jfeatures.normalize_rows(jnp.asarray(mixed.numpy())),
        jnp.asarray(features.build_mel_weights(cfg)), n_fft=512, hop=100,
        channels=1)
    masked = features.apply_spec_augment(torch.from_numpy(np.array(want)),
                                         draw)
    assert _rel(got, masked) < REL
    assert (got == 0).sum() == (masked == 0).sum() > 0


def _merge_batch(batch, seed):
    rng = np.random.default_rng(seed)
    cfg = FeaturizerConfig(**SMALL)
    return (rng.standard_normal((batch, cfg.samples_per_clip)).astype(
                np.float32),
            rng.standard_normal((batch, 68, 60)).astype(np.float32),
            np.abs(rng.standard_normal((batch, 136, 3))).astype(np.float32))


def test_merge_preprocess_eval_matches_jax():
    xs, y = _merge_batch(3, 10), _labels(3, 4)
    got, got_y = pre.make_merge_preprocess_fn(FeaturizerConfig(**SMALL),
                                              device="cpu")(xs, y)
    want, want_y = jpre.make_merge_preprocess_fn(JaxConfig(**SMALL))(
        tuple(jnp.asarray(a) for a in xs), jnp.asarray(y))
    assert got[0].shape == (3, 96, 240, 1)
    assert _rel(got[0], want[0]) < REL
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("chance", [0.0, 1.0])
def test_merge_preprocess_augmented_matches_jax_with_its_weights(chance):
    """One lambda a sample mixes the waveform, both feature tensors and the
    label: the port's batch against JAX's mixing, normalizing and
    featurizing functions applied with the weights the port drew."""
    cfg = FeaturizerConfig(**SMALL)
    xs, xs2 = _merge_batch(4, 11), _merge_batch(4, 12)
    y, y2 = _labels(4, 5), _labels(4, 6)
    got, got_y = pre.make_merge_preprocess_fn(
        cfg, augment=True, mixup_chance=chance, device="cpu")(
        xs, y, xs2, y2, torch.Generator().manual_seed(1))
    l = features.sample_mix_weights(torch.Generator().manual_seed(1), 4,
                                    chance=chance)
    jl = jnp.asarray(l.numpy())
    mix = [jfeatures.apply_mix(jl, jnp.asarray(a), jnp.asarray(b))
           for a, b in zip(xs, xs2)]
    mel = jselect.make_mel_fn(JaxConfig(**SMALL), precision="default")(
        jfeatures.normalize_rows(mix[0]))[..., None]
    assert _rel(got[0], mel) < REL
    for g, w in zip(got[1:], mix[1:]):
        assert _rel(g, w) < NORM_REL
    want_y = jfeatures.mix_labels(jl, jnp.asarray(y), jnp.asarray(y2))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    if chance == 0.0:  # every sample is its partner
        np.testing.assert_array_equal(got[1].numpy(), xs2[1])


def test_feature_towers_take_a_bf16_compute_dtype():
    """cnn-features (merge's feature towers) at the bf16 compute dtype of
    a training run: the towers' last Dense, built without a dtype, takes
    their bf16 maps in f32 as Flax promotes them.  Logits within 2e-2 of
    max |logit| of the Flax bf16 model on the same weights (bf16 roundings
    at different points)."""
    rng = np.random.default_rng(13)
    short = rng.standard_normal((2, 68, 60)).astype(np.float32)
    mid = rng.standard_normal((2, 136, 3)).astype(np.float32)
    jspec = jax_build_model("cnn-features", 5, logits_only=True,
                            dtype=jnp.bfloat16)
    v = jspec.module.init(jax.random.PRNGKey(0), jnp.asarray(short),
                          jnp.asarray(mid))
    want = jspec.module.apply(v, jnp.asarray(short), jnp.asarray(mid))
    port = build_model("cnn-features", 5, logits_only=True,
                       dtype=torch.bfloat16).module
    port.load_state_dict(state_dict_from_flax(port, v))
    got = port.eval()(torch.from_numpy(short), torch.from_numpy(mid))
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) < 2e-2
