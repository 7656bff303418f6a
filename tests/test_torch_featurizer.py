"""The fused featurizer (K1) of the port against the JAX package.

On the CPU the port's ``FusedFeaturizer`` runs its plain version; it is
held against the JAX Pallas kernel in interpret mode on a short clip and
against the JAX rfft path at the full 3 s geometry, in the tf framing and in
the centered framing of the Predictor (there also against the JAX
``stft_centered`` power -> mel and ``MatmulMelPlan(center=True)``).
Tolerances as in
tests/test_fused_featurizer.py: mel global relative error < 1e-5, PCEN
absolute error < 1e-4 (output range [-1, 1]), bf16 output bitwise the cast
of the f32 output.  The CUDA kernel itself is checked against the plain
version by tests/test_torch_gpu.py, which runs only where a card is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.ops.fftmel import MatmulMelPlan
from audio_training_tpu.ops.stft import stft_centered as jax_stft_centered
from audio_training_tpu.ops.featurizer_select import make_mel_fn as jax_make_mel_fn
from audio_training_tpu.ops.pallas.fused_featurizer import (
    FusedFeaturizer as JaxFusedFeaturizer,
)
from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.features import build_mel_weights, mel_power
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
from audio_training_tpu_torch.ops.pcen import pcen

torch.set_num_threads(2)

MEL_REL = 1e-5
PCEN_ABS = 1e-4
SHORT = 24000  # 0.5 s keeps the JAX interpret-mode kernel cheap


@pytest.fixture(scope="module")
def cfg():
    return FeaturizerConfig()


@pytest.fixture(scope="module")
def mel_w(cfg):
    return build_mel_weights(cfg)


@pytest.fixture(scope="module")
def fz(cfg, mel_w):
    return ffz.FusedFeaturizer(mel_w, cfg.n_fft, cfg.hop_length, device="cpu")


def _clips(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_matches_jax_kernel_interpret(mel_w, fz):
    raw = _clips(2, SHORT, 1)
    jfz = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest")
    want_mel = jfz(jnp.asarray(raw), pcen=False, interpret=True)
    got_mel = fz(torch.from_numpy(raw), pcen=False)
    assert got_mel.shape == (2, 160, -(-SHORT // 281))
    assert _rel(got_mel, want_mel) < MEL_REL
    want_pcen = np.asarray(jfz(jnp.asarray(raw), pcen=True, interpret=True))
    got_pcen = fz(torch.from_numpy(raw), pcen=True).numpy()
    assert np.abs(got_pcen - want_pcen).max() < PCEN_ABS


def test_plain_matches_jax_rfft_full_geometry(cfg, fz):
    raw = _clips(2, cfg.samples_per_clip, 2)
    want = jax_make_mel_fn(JaxConfig(), backend="rfft")(jnp.asarray(raw))
    got = fz(torch.from_numpy(raw), pcen=False)
    assert got.shape == (2, 160, 513)
    assert _rel(got, want) < MEL_REL


@pytest.mark.parametrize("hop", [160, 313])
def test_other_hops_match_jax_rfft(mel_w, hop):
    raw = _clips(1, 30000, hop)
    jcfg = JaxConfig(hop_length=hop)
    want = jax_make_mel_fn(jcfg, mel_weights=mel_w, backend="rfft")(
        jnp.asarray(raw))
    got = ffz.FusedFeaturizer(mel_w, 4096, hop, device="cpu")(
        torch.from_numpy(raw), pcen=False)
    assert got.shape[-1] == -(-30000 // hop)
    assert _rel(got, want) < MEL_REL


@pytest.mark.parametrize("batch", [1, 3])
def test_batch_one_and_odd_batch(cfg, fz, batch):
    raw = torch.from_numpy(_clips(batch, cfg.samples_per_clip, 21))
    out = fz(raw, pcen=False)
    assert out.shape == (batch, cfg.n_mels, cfg.mel_frames)
    assert torch.isfinite(out).all()
    # rows are independent: each clip alone gives its row of the batch
    assert _rel(fz(raw[-1:], pcen=False)[0], out[-1]) < 1e-6


@pytest.mark.parametrize("use_pcen", [False, True])
def test_bf16_output_is_the_cast(fz, use_pcen):
    raw = torch.from_numpy(_clips(2, SHORT, 4))
    f32 = fz(raw, pcen=use_pcen, normalize=False)
    b16 = fz(raw, pcen=use_pcen, normalize=False, out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    if use_pcen:
        # normalized PCEN: the min-max runs on the bf16 output
        out = fz(raw, pcen=True, out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        assert out.min() == -1.0 and out.max() == 1.0


def test_pcen_rows_plain_matches_ops_pcen(fz):
    mel = mel_power(torch.from_numpy(_clips(2, SHORT, 6)), fz.mel_weights)
    want = pcen(mel, *fz.pcen_params, time_axis=2, normalize=False)
    assert torch.equal(ffz.pcen_rows(mel, fz.pcen_params), want)


def test_constructor_rejects_what_jax_rejects(mel_w):
    wide = build_mel_weights(FeaturizerConfig(fmax=20000.0))
    for w, n_fft, match in [(mel_w, 2048, "n_fft=4096"),
                            (wide, 4096, "exceeds bin 1023")]:
        with pytest.raises(ValueError, match=match):
            JaxFusedFeaturizer(w, n_fft, 281)
        with pytest.raises(ValueError, match=match):
            ffz.FusedFeaturizer(w, n_fft, 281, device="cpu")
        assert ffz.geometry_error(w, n_fft) is not None
    assert ffz.geometry_error(mel_w, 4096) is None


# 144,000 samples: 513 frames in both framings; 28,100 = 100 hops: 100 tf
# frames, 101 centered ones
@pytest.mark.parametrize("samples", [144000, 28100])
def test_centered_plain_matches_jax_stft_centered(mel_w, samples):
    raw = _clips(1, samples, 31)
    spec = jax_stft_centered(jnp.asarray(raw), 4096, 281)  # (B, F, T)
    power = np.asarray(jnp.real(spec) ** 2 + jnp.imag(spec) ** 2, np.float64)
    want = np.einsum("mf,bft->bmt", mel_w.astype(np.float64), power)
    fz_c = ffz.FusedFeaturizer(mel_w, 4096, 281, center=True, device="cpu")
    got = fz_c(torch.from_numpy(raw), pcen=False)
    assert got.shape == (1, 160, 1 + samples // 281)
    assert _rel(got, want) < MEL_REL
    plan = MatmulMelPlan(mel_w, 4096, 281, center=True, precision="highest")
    assert _rel(got, plan(jnp.asarray(raw))) < MEL_REL
    assert torch.equal(got, ffz.fused_featurizer_plain(
        torch.from_numpy(raw), fz_c.mel_weights, 281, center=True))


def test_centered_pcen_matches_jax_kernel_interpret(mel_w):
    raw = _clips(2, SHORT, 32)
    jfz = JaxFusedFeaturizer(mel_w, 4096, 281, precision="highest",
                             center=True)
    fz_c = ffz.FusedFeaturizer(mel_w, 4096, 281, center=True, device="cpu")
    want_mel = jfz(jnp.asarray(raw), pcen=False, interpret=True)
    got_mel = fz_c(torch.from_numpy(raw), pcen=False)
    assert got_mel.shape == (2, 160, 1 + SHORT // 281)
    assert _rel(got_mel, want_mel) < MEL_REL
    want = np.asarray(jfz(jnp.asarray(raw), pcen=True, interpret=True))
    got = fz_c(torch.from_numpy(raw), pcen=True).numpy()
    assert np.abs(got - want).max() < PCEN_ABS


def test_deferred_modes_raise(mel_w, fz):
    """Every mode of the JAX class is ported; what still raises are the JAX
    class's own contracts (a fold with center=True, the frontend fold with
    PCEN), a tier the JAX class does not have, and inputs the kernels do
    not take."""
    raw = torch.zeros(1, SHORT)
    fp = (np.float32(-1.0), np.zeros(160, np.float32),
          np.ones(160, np.float32))
    for tier in ffz.PRECISIONS:
        # the tensor-core tiers take the centered framing too
        fz_c = ffz.FusedFeaturizer(mel_w, precision=tier, center=True,
                                   device="cpu")
        assert fz_c(raw, pcen=False).shape == (1, 160, 1 + SHORT // 281)
        for kw in (dict(normalize_waveform=True), dict(frontend_params=fp)):
            with pytest.raises(ValueError, match="not the centered one"):
                fz_c(raw, pcen=False, **kw)
        with pytest.raises(ValueError, match="PCEN fronts"):
            ffz.FusedFeaturizer(mel_w, precision=tier, device="cpu")(
                raw, pcen=True, frontend_params=fp)
    with pytest.raises(ValueError, match="unknown precision tier"):
        ffz.FusedFeaturizer(mel_w, precision="high", device="cpu")
    with pytest.raises(ValueError, match="out_dtype"):
        fz(raw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        fz(raw.double())


@pytest.mark.parametrize("fold", ["normalize_waveform", "frontend_params"])
def test_folds_run_at_every_tier(mel_w, fold):
    """Each fold runs at each tier in tf framing (parity with the JAX folds:
    tests/test_torch_folds.py)."""
    raw = torch.from_numpy(_clips(1, SHORT, 40))
    kw = ({"normalize_waveform": True} if fold == "normalize_waveform" else
          {"frontend_params": (np.float32(-1.0), np.zeros(160, np.float32),
                               np.ones(160, np.float32))})
    for tier in ffz.PRECISIONS:
        out = ffz.FusedFeaturizer(mel_w, precision=tier, device="cpu")(
            raw, pcen=False, **kw)
        assert out.shape == (1, 160, -(-SHORT // 281))
        assert torch.isfinite(out).all()


def test_make_mel_fn_backends(cfg, mel_w):
    raw = torch.from_numpy(_clips(1, SHORT, 8))
    rfft = make_mel_fn(cfg, backend="rfft", device="cpu")(raw)
    # auto on a CPU device takes the plain rfft path; "fused" on a CPU
    # tensor runs the kernel's plain version: the same numbers
    assert torch.equal(make_mel_fn(cfg, device="cpu")(raw), rfft)
    assert torch.equal(make_mel_fn(cfg, backend="fused", device="cpu")(raw),
                       rfft)
    want = pcen(rfft, time_axis=2)
    got = make_mel_fn(cfg, backend="fused", device="cpu", pcen=True)(raw)
    assert (got - want).abs().max() < PCEN_ABS
    assert torch.equal(make_mel_fn(cfg, device="cpu", pcen=True)(raw), want)
    with pytest.raises(ValueError, match="unknown featurizer backend"):
        make_mel_fn(cfg, backend="matmul", device="cpu")

