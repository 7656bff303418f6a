"""The power-mel op (K2) of the port against the JAX package.

On the CPU the port's ``fused_power_mel`` runs its plain version; it is held
against the JAX Pallas kernel ``fused_power_mel`` in interpret mode at the
shape of tests/test_features.py::test_fused_power_mel_matches_einsum and at
the Predictor's ragged n_fft=2048 shape, (1, 513, 1025) x (1025, 160).
Tolerance: global relative error < 1e-5 of max |out| (both sides exact
fp32; they sum in other orders).  The CUDA kernel itself is checked against
the plain version by tests/test_torch_gpu.py, which runs only where a card
is; here a numpy emulation of its loops (the support staging on the 16-byte
pair grid, the band walk of ``band_walk_plan``) is held against the plain
version and the JAX kernel over the geometries the Predictor may take.
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
from audio_training_tpu_torch.ops.mel import band_tables

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


def _kernel_band_walk(re, im, w_t, a0, interleaved):
    """csrc/melspec.cu's loops in numpy, float64 sums: per tile of ROWS
    rows, the power of the support bins staged (interleaved: float4 pairs
    on the 16-byte grid of a complex64 tensor whose address is a0 complex
    elements past it; the memory around the tensor reads NaN, so a pair
    element taken from outside the support would show), then the band walk
    of each (filter, row group)."""
    plan = melspec.band_walk_plan(w_t)
    b, t, f = re.shape
    rows, n_mels, support = b * t, w_t.shape[1], plan.support
    nan = np.full(2 * a0, np.nan, np.float32)
    mem = np.concatenate([nan, np.stack([re, im], -1).ravel(),
                          np.full(4, np.nan, np.float32)]).astype(np.float64)
    flat_re, flat_im = re.ravel().astype(np.float64), im.ravel()
    out = np.full((rows, n_mels), np.nan)
    for row0 in range(0, rows, melspec.ROWS):
        power = np.full((melspec.ROWS, support), np.nan)
        per_row = support // 2 + 2 if interleaved else support
        for i in range(melspec.ROWS * per_row):
            r, q = divmod(i, per_row)
            row = row0 + r
            if row >= rows:
                continue
            first = row * f + plan.lo
            if not interleaved:
                power[r, q] = flat_re[first + q] ** 2 + flat_im[first + q] ** 2
                continue
            p = ((first + a0) >> 1) + q
            k = 2 * p - a0 - first
            if k >= support:
                continue
            v = mem[4 * p:4 * p + 4]
            if k >= 0:
                power[r, k] = v[0] ** 2 + v[1] ** 2
            if k + 1 < support:
                power[r, k + 1] = v[2] ** 2 + v[3] ** 2
        for i in range(n_mels * (melspec.ROWS // melspec.RPT)):
            m, g = i % n_mels, i // n_mels
            s, n = plan.start[m] - plan.lo, plan.length[m]
            w = plan.weights[plan.offset[m]:plan.offset[m] + n]
            acc = power[g * melspec.RPT:(g + 1) * melspec.RPT, s:s + n] @ w
            for k in range(melspec.RPT):
                if row0 + g * melspec.RPT + k < rows:
                    out[row0 + g * melspec.RPT + k, m] = acc[k]
    return out.reshape(b, t, n_mels)


@pytest.mark.parametrize("fmax", [11000.0, 24000.0])  # up to sr / 2
@pytest.mark.parametrize("n_mels", [64, 128, 160])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_band_walk_matches_plain_and_jax(n_fft, n_mels, fmax):
    """The kernel's band walk over the mel bank of each geometry (empty
    filters at n_fft 512 included) equals the dense product of the plain
    version and of the JAX kernel, for both entries and both alignments of
    a complex64 tensor, on 2 x 11 rows (two tiles, the second ragged)."""
    w = build_mel_weights(FeaturizerConfig(n_fft=n_fft, n_mels=n_mels,
                                           fmax=fmax))
    w_t = np.ascontiguousarray(w.T)
    re, im = _stft((2, 11, w_t.shape[0]), n_fft + n_mels)
    plan = melspec.band_walk_plan(w_t)
    support = np.flatnonzero(w.max(axis=0) > 0)
    assert (plan.lo, plan.lo + plan.support) == (support[0], support[-1] + 1)
    assert plan.length.sum() == len(plan.weights)
    want = jax_fused_power_mel(jnp.asarray(re), jnp.asarray(im),
                               jnp.asarray(w_t), interpret=True)
    plain = melspec.power_mel_plain(torch.from_numpy(re),
                                    torch.from_numpy(im),
                                    torch.from_numpy(w_t))
    assert _rel(plain, want) < REL
    for a0, interleaved in ((0, True), (1, True), (0, False)):
        got = _kernel_band_walk(re, im, w_t, a0, interleaved)
        assert np.isfinite(got).all()
        assert _rel(got, plain) < REL


def test_band_tables_cover_every_non_zero():
    """Each filter's band spans its first to last non-zero weight; outside
    it the row is zero, inside it the flat weights are the row's."""
    rng = np.random.default_rng(8)
    w = rng.random((12, 40)).astype(np.float32) * (rng.random((12, 40)) < .3)
    w[3] = 0.0  # an empty filter
    w[5, :7] = 0.0
    w[5, 20] = -0.5  # a negative weight still belongs to the band
    start, length, offset, flat = band_tables(w)
    assert length[3] == 0
    for m in range(12):
        band = np.zeros(40, np.float32)
        band[start[m]:start[m] + length[m]] = flat[offset[m]:
                                                  offset[m] + length[m]]
        np.testing.assert_array_equal(band, w[m])
