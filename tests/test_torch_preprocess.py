"""The port's batch preprocess and mixup against the JAX package's, on the
CPU.

JAX keys and torch generators draw different bits, so the mixup weights
are injected into ``apply_mix``/``mix_labels`` (1e-5) and the samplers are
tested by their distributions.  ``make_preprocess_fn``: the eval path and
the augmented path at ``mixup_chance=0`` (deterministic: every sample is
its partner) match JAX at 1e-5 global relative error on the default
("auto") backend, which on the CPU is the exact rfft path on both sides;
with ``backend="fused"`` the augmented path runs the "default" tier's plain
version and matches at the tier's 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.data import preprocess as jpre
from audio_training_tpu.ops import features as jfeatures
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.data import preprocess as pre
from audio_training_tpu_torch.ops import features

torch.set_num_threads(2)

REL = 1e-5
TIER_REL = 1e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _batch(batch, samples, labels, seed):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((batch, samples)).astype(np.float32)
    y = np.eye(labels, dtype=np.float32)[rng.integers(0, labels, batch)]
    return raw, y


@pytest.mark.parametrize("single_label", [True, False])
def test_mix_with_injected_weights_matches_jax(single_label):
    rng = np.random.default_rng(0)
    l = np.array([0.0, 0.3, 0.5, 0.51, 1.0], np.float32)
    one, two = (rng.standard_normal((5, 7, 3)).astype(np.float32)
                for _ in range(2))
    y1, y2 = (rng.integers(0, 2, (5, 4)).astype(np.float32) for _ in range(2))
    got = features.apply_mix(torch.from_numpy(l), torch.from_numpy(one),
                             torch.from_numpy(two))
    want = jfeatures.apply_mix(jnp.asarray(l), jnp.asarray(one),
                               jnp.asarray(two))
    assert _rel(got, want) < REL
    got = features.mix_labels(torch.from_numpy(l), torch.from_numpy(y1),
                              torch.from_numpy(y2), single_label)
    want = jfeatures.mix_labels(jnp.asarray(l), jnp.asarray(y1),
                                jnp.asarray(y2), single_label)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=1e-7)


def test_samplers_by_their_distribution():
    """Beta(0.5, 0.5): mean 1/2, variance 1/8; mixing weights are zero with
    probability 1 - chance.  20,000 draws: bounds of about 5 standard
    errors."""
    gen = torch.Generator().manual_seed(0)
    b = features.sample_beta(gen, 20000, 0.5)
    assert 0.0 <= b.min() and b.max() <= 1.0
    assert abs(b.mean().item() - 0.5) < 0.015
    assert abs(b.var().item() - 0.125) < 0.005
    l = features.sample_mix_weights(gen, 20000, alpha=0.5, chance=0.25)
    assert abs((l > 0).float().mean().item() - 0.25) < 0.02
    again = features.sample_beta(torch.Generator().manual_seed(0), 20000, 0.5)
    assert torch.equal(again, b)  # the generator alone decides the draws
    raw, y = _batch(6, 50, 3, 1)
    raw2, y2 = _batch(6, 50, 3, 2)
    mixed, ym = features.mix_up(torch.Generator().manual_seed(1),
                                torch.from_numpy(raw), torch.from_numpy(y),
                                torch.from_numpy(raw2), torch.from_numpy(y2),
                                chance=0.0)
    assert torch.equal(mixed, torch.from_numpy(raw2))
    assert torch.equal(ym, torch.from_numpy(y2))


@pytest.fixture(scope="module")
def clips():
    cfg = FeaturizerConfig()
    return (cfg, *_batch(2, cfg.samples_per_clip, 5, 3),
            *_batch(2, cfg.samples_per_clip, 5, 4))


def test_eval_preprocess_matches_jax(clips):
    cfg, raw, y, _, _ = clips
    want_mel, want_y = jpre.make_preprocess_fn(JaxConfig())(
        jnp.asarray(raw), jnp.asarray(y))
    mel, yy = pre.make_preprocess_fn(cfg, device="cpu")(raw, y)
    assert mel.shape == (2, 160, 513, 1) and mel.dtype == torch.float32
    assert _rel(mel, want_mel) < REL
    np.testing.assert_array_equal(yy.numpy(), np.asarray(want_y))


def test_augmented_preprocess_at_chance_zero_matches_jax(clips):
    cfg, raw, y, raw2, y2 = clips
    want_mel, want_y = jpre.make_preprocess_fn(JaxConfig(), augment=True,
                                               mixup_chance=0.0)(
        jnp.asarray(raw), jnp.asarray(y), jnp.asarray(raw2),
        jnp.asarray(y2), jax.random.PRNGKey(0))
    for backend, tol in (("auto", REL), ("fused", TIER_REL)):
        fn = pre.make_preprocess_fn(cfg, augment=True, mixup_chance=0.0,
                                    backend=backend, device="cpu")
        mel, yy = fn(raw, y, raw2, y2, torch.Generator().manual_seed(0))
        assert _rel(mel, want_mel) < tol, backend
        np.testing.assert_array_equal(yy.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(yy.numpy(), y2)


def test_image_options_match_jax():
    """db_scale, mean_sub and a 3-channel repeat on a short clip."""
    kw = dict(segment_length=0.75, n_mels=96, db_scale=True, mean_sub=True)
    raw, y = _batch(2, 36000, 4, 5)
    want, _ = jpre.make_preprocess_fn(JaxConfig(**kw), channels=3)(
        jnp.asarray(raw), jnp.asarray(y))
    got, _ = pre.make_preprocess_fn(FeaturizerConfig(**kw), channels=3,
                                    device="cpu")(raw, y)
    assert got.shape == (2, 96, 129, 3)
    assert _rel(got, want) < REL


def test_unported_options_raise():
    cfg = FeaturizerConfig()
    for kw in ({"dual": True}, {"augment": True, "use_spec_augment": True}):
        with pytest.raises(NotImplementedError, match="Training from a built corpus"):
            pre.make_preprocess_fn(cfg, device="cpu", **kw)


def test_class_weighting_matches_jax():
    labels = ["kiwi", "tui", "noise", "human", "bird"]
    batches = [_batch(8, 2, 5, s) for s in range(3)]
    batches.append((None, np.zeros((4, 5), np.float32)))
    dist, total = pre.get_distribution(batches, 5)
    jdist, jtotal = jpre.get_distribution(batches, 5)
    np.testing.assert_array_equal(dist, jdist)
    assert total == jtotal == 28
    dist[1] = 0.0
    for dont in (None, ["noise"]):
        w = pre.get_weighting(dist, labels, dont)
        assert w == jpre.get_weighting(dist, labels, dont)
        np.testing.assert_array_equal(pre.weights_to_array(w, 5),
                                      jpre.weights_to_array(w, 5))
