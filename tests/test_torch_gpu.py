"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and nvcc and skip elsewhere (the kernels have
no CPU mode).  They import nothing of JAX, so they also run where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Tolerances as on the
CPU: mel global relative error < 1e-5, PCEN absolute error < 1e-4, bf16
output bitwise the cast of the f32 output.  TF32 is off for the plain
version's einsum.
"""

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights
from audio_training_tpu_torch.ops.pcen import pcen

torch.set_num_threads(2)

MEL_REL = 1e-5
PCEN_ABS = 1e-4


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("batch,samples,hop", [
    (3, 144000, 281),  # production clip, odd batch
    (1, 30000, 313),   # short clip, another hop, odd frame count
    (2, 20000, 160),
])
def test_fused_featurizer_kernel_matches_plain(batch, samples, hop):
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, 4096, hop, device=dev)
    raw = torch.from_numpy(np.random.default_rng(hop).standard_normal(
        (batch, samples)).astype(np.float32)).to(dev)
    ffz.reset_launch_counts()
    mel = fz(raw, pcen=False)
    assert ffz.launch_counts()["fused_featurizer_mel"] == 1
    want = ffz.fused_featurizer_plain(raw, fz.mel_weights, hop)
    assert mel.shape == want.shape == (batch, 160, -(-samples // hop))
    assert _rel(mel, want) < MEL_REL
    b16 = fz(raw, pcen=False, out_dtype=torch.bfloat16)
    assert torch.equal(b16, mel.to(torch.bfloat16))
    got = fz(raw, pcen=True)
    assert (got - pcen(want, *fz.pcen_params, time_axis=2)).abs().max() < PCEN_ABS
    raw_pcen = fz(raw, pcen=True, normalize=False)
    assert torch.equal(fz(raw, pcen=True, normalize=False,
                          out_dtype=torch.bfloat16),
                       raw_pcen.to(torch.bfloat16))
    assert ffz.launch_counts() == {"fused_featurizer_mel": 5,
                                   "fused_featurizer_pcen": 3}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    fz = ffz.FusedFeaturizer(build_mel_weights(FeaturizerConfig()), device=dev)
    raw = torch.zeros(2, 144000, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fz(raw.t().contiguous().t(), pcen=False)
    with pytest.raises(ValueError, match="is on"):
        fz(raw.cpu(), pcen=False)
    with pytest.raises(ValueError, match="float32"):
        fz(raw.half(), pcen=False)
