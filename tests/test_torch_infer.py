"""The whole slice: waveform -> featurizer [-> PCEN] -> model, the port's
``make_fused_infer_fn(..., device="cpu")`` against the JAX
``make_fused_infer_fn(..., use_pallas=False)`` at the production geometry
(3 s at 48 kHz, 160 mels x 513 frames), B=1, 62 labels, on converted
weights.  Tolerance: 1e-4 of max |output| (f32 throughout).

badwinner2 takes mel power: on a PCEN image (values in [-1, 1]) its
MagTransform raises negatives to a fractional power, NaN in both packages.
The PCEN cases therefore run a fixed linear head, identical on both sides,
so the comparison sees the featurizer, PCEN and the channel repeat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.infer.fused import make_fused_infer_fn as jax_infer_fn
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import (
    badwinner2_state_dict_from_flax,
)

from test_torch_badwinner2 import flax_variables

torch.set_num_threads(2)

NUM_LABELS = 62
REL = 1e-4


class JaxLinearHead(linen.Module):
    @linen.compact
    def __call__(self, x, train=False):
        proj = self.param("proj", linen.initializers.zeros, (NUM_LABELS,) + x.shape[1:])
        return jnp.einsum("bmtc,lmtc->bl", x, proj,
                          precision="highest")


class TorchLinearHead(torch.nn.Module):
    def __init__(self, proj: np.ndarray):
        super().__init__()
        self.proj = torch.nn.Parameter(torch.from_numpy(proj))

    def forward(self, x):
        return torch.einsum("bmtc,lmtc->bl", x, self.proj)


@pytest.fixture(scope="module")
def raw():
    cfg = FeaturizerConfig()
    return np.random.default_rng(17).uniform(
        -1.0, 1.0, (1, cfg.samples_per_clip)).astype(np.float32)


@pytest.mark.parametrize("probabilities", [False, True])
def test_badwinner2_slice_matches_jax(raw, probabilities):
    cfg = FeaturizerConfig()
    module, v = flax_variables((1, 160, 513, 1), num_labels=NUM_LABELS)
    model = build_model("badwinner2", NUM_LABELS, logits_only=True).module
    model.load_state_dict(badwinner2_state_dict_from_flax(v))
    want = jax_infer_fn(module, v, JaxConfig(), use_pallas=False,
                        probabilities=probabilities)(jnp.asarray(raw))
    got = make_fused_infer_fn(model, cfg, probabilities=probabilities,
                              device="cpu")(raw)
    assert got.shape == (1, NUM_LABELS)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < REL * np.abs(want).max()


@pytest.mark.parametrize("channels,probabilities", [(1, False), (3, True)])
def test_pcen_slice_matches_jax(raw, channels, probabilities):
    cfg = FeaturizerConfig()
    proj = np.random.default_rng(5).standard_normal(
        (NUM_LABELS, cfg.n_mels, cfg.mel_frames, channels)).astype(
            np.float32) / 100.0
    want = jax_infer_fn(JaxLinearHead(), {"params": {"proj": proj}},
                        JaxConfig(), use_pcen=True, use_pallas=False,
                        channels=channels, probabilities=probabilities)(
        jnp.asarray(raw))
    got = make_fused_infer_fn(TorchLinearHead(proj), cfg, use_pcen=True,
                              channels=channels, probabilities=probabilities,
                              device="cpu")(raw)
    want = np.asarray(want)
    assert got.shape == want.shape == (1, NUM_LABELS)
    assert np.abs(got.numpy() - want).max() < REL * np.abs(want).max()
