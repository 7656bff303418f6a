"""The power-mel op (K2) of the port against the JAX package.

On the CPU the port's ``fused_power_mel`` runs its plain version; it is held
against the JAX Pallas kernel ``fused_power_mel`` in interpret mode at the
shape of tests/test_features.py::test_fused_power_mel_matches_einsum and at
the Predictor's ragged n_fft=2048 shape, (1, 513, 1025) x (1025, 160).
Tolerance: global relative error < 1e-5 of max |out| (both sides exact
fp32; they sum in other orders).  The CUDA kernel itself is checked against
the plain version by tests/test_torch_gpu.py, which runs only where a card
is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.ops.pallas.melspec import (
    fused_power_mel as jax_fused_power_mel,
)
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import melspec
from audio_training_tpu_torch.ops.features import build_mel_weights

torch.set_num_threads(2)

REL = 1e-5


def _stft(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _production_bank_t():
    w = build_mel_weights(FeaturizerConfig(n_fft=2048))
    return np.ascontiguousarray(w.T)  # (1025, 160)


@pytest.mark.parametrize("b,t,f,m", [(2, 100, 513, 64), (1, 513, 1025, 160)])
def test_plain_matches_jax_kernel_interpret(b, t, f, m):
    re, im = _stft((b, t, f), 3 + t)
    if f == 1025:
        w_t = _production_bank_t()
    else:
        w_t = np.random.default_rng(4).random((f, m)).astype(np.float32)
    want = jax_fused_power_mel(jnp.asarray(re), jnp.asarray(im),
                               jnp.asarray(w_t), interpret=True)
    got = melspec.fused_power_mel(torch.from_numpy(re), torch.from_numpy(im),
                                  torch.from_numpy(w_t))
    assert got.shape == (b, t, m) and got.dtype == torch.float32
    assert _rel(got, want) < REL


def test_complex_entry_equals_the_split_entry():
    re, im = _stft((2, 37, 129), 5)
    w_t = torch.from_numpy(np.random.default_rng(6).random((129, 20)).astype(
        np.float32))
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    got = melspec.fused_power_mel_complex(spec, w_t)
    want = melspec.fused_power_mel(spec.real.contiguous(),
                                   spec.imag.contiguous(), w_t)
    assert torch.equal(got, want)
    assert torch.equal(want, melspec.power_mel_plain(
        torch.from_numpy(re), torch.from_numpy(im), w_t))


def test_cpu_tensors_do_not_launch():
    re, im = _stft((1, 8, 16), 7)
    melspec.reset_launch_counts()
    melspec.fused_power_mel(torch.from_numpy(re), torch.from_numpy(im),
                            torch.ones(16, 4))
    assert melspec.launch_counts() == {"power_mel": 0}


def test_wrappers_reject_what_the_kernel_does_not_take():
    re = torch.zeros(1, 8, 16)
    w_t = torch.ones(16, 4)
    with pytest.raises(ValueError, match="float32"):
        melspec.fused_power_mel(re.double(), re.double(), w_t)
    with pytest.raises(ValueError, match="B, T, F"):
        melspec.fused_power_mel(re, torch.zeros(1, 8, 15), w_t)
    with pytest.raises(ValueError, match="17 bins"):
        melspec.fused_power_mel(re, re, torch.ones(17, 4))
    with pytest.raises(ValueError, match="complex64"):
        melspec.fused_power_mel_complex(re, w_t)
    with pytest.raises(ValueError, match=r"\(F, M\) float32"):
        melspec.fused_power_mel(re, re, w_t.double())
