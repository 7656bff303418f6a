"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and nvcc and skip elsewhere (the kernels have
no CPU mode).  They import nothing of JAX, so they also run where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Tolerances as on the
CPU: mel and power-mel global relative error < 1e-5, PCEN absolute error
< 1e-4, bf16 output bitwise the cast of the f32 output, Predictor
probabilities of the kernel path within 1e-4 of max |p| of the plain
featurizer's; the "default" (bf16) tier as stated above its test; the
"bf16_3x" tier within 2e-5 of its plain version and 5e-5 of the exact
kernel, "bf16_3x_manual" bitwise equal to it; the PCEN -> MobileNetV2
chain's f32 logits within 1e-4 of max |logit| of the plain featurizer's
(and of the exact tier's, for "bf16_3x"), the folded gray stem's within
1e-5.  TF32 is off for the plain versions' einsums and the CNN.
"""

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.infer import Predictor
from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
from audio_training_tpu_torch.models import build_model, fold_gray_stem
from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
from audio_training_tpu_torch.ops.cuda import melspec
from audio_training_tpu_torch.ops.features import (
    build_mel_weights,
    mel_power,
    normalize_rows,
)
from audio_training_tpu_torch.ops.pcen import pcen

torch.set_num_threads(2)

MEL_REL = 1e-5
PCEN_ABS = 1e-4


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
                                   "fused_featurizer_mel_centered": 0,
                                   "fused_featurizer_mel_bf16": 0,
                                   "fused_featurizer_mel_bf16x3": 0,
                                   "fused_featurizer_pcen": 3}


def _tone_clips(batch, samples, seed):
    """Normalized clips of a few tones over faint noise: audio whose mel
    maxima are tonal, as on the training path."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 48000
    clips = [sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f * t)
                 for f in rng.uniform(200.0, 9000.0, 3))
             + 0.05 * rng.standard_normal(samples) for _ in range(batch)]
    return normalize_rows(torch.from_numpy(np.stack(clips).astype(np.float32)))


def _impulses(batch, samples, seed):
    """At most one impulse in any 4096-sample frame: every sum that the
    tier rounds to bf16 then has one non-zero term, so no summation order
    can flip a rounding."""
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, samples), np.float32)
    for row in x:
        pos = np.arange(rng.integers(0, 4099), samples, 4099)
        row[pos] = rng.uniform(0.3, 1.0, len(pos)) * rng.choice([-1, 1], len(pos))
    return torch.from_numpy(x)


# The "default" tier's kernel and plain version share the six bf16 rounding
# points and differ in f32 summation order only; that order flips a bf16
# rounding of a stage-1 plane or a power bin now and then, which moves the
# value by one bf16 step.  So: where no flip can happen (impulses), global
# relative error < 1e-4; on audio, relative RMS error < 1e-4 and no value
# off by more than one bf16 step of the max (2^-7); against the exact
# "highest" kernel, the tier's own class, < 1e-2.
BF16_FLIP_FREE_REL = 1e-4
BF16_RMS_REL = 1e-4
BF16_STEP = 2.0 ** -7
BF16_VS_EXACT = 1e-2


def _rms_rel(got, want):
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("batch,samples,hop", [
    (3, 144000, 281),  # production clip: 513 frames, a 1-frame last tile
    (1, 30000, 313),
])
def test_bf16_tier_kernel_matches_plain(batch, samples, hop):
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, 4096, hop, precision="default", device=dev)
    exact = ffz.FusedFeaturizer(w, 4096, hop, device=dev)
    noise = normalize_rows(torch.from_numpy(np.random.default_rng(
        hop).standard_normal((batch, samples)).astype(np.float32)))
    for kind, raw in (("impulses", _impulses(batch, samples, hop)),
                      ("tones", _tone_clips(batch, samples, hop)),
                      ("noise", noise)):
        raw = raw.to(dev)
        ffz.reset_launch_counts()
        mel = fz(raw, pcen=False)
        assert ffz.launch_counts()["fused_featurizer_mel_bf16"] == 1
        want = ffz.fused_featurizer_plain(raw, fz.mel_weights, hop,
                                          precision="default")
        assert mel.shape == want.shape == (batch, 160, -(-samples // hop))
        if kind == "impulses":
            assert _rel(mel, want) < BF16_FLIP_FREE_REL
            continue
        assert _rms_rel(mel, want) < BF16_RMS_REL, kind
        assert _rel(mel, want) < BF16_STEP, kind
        assert _rel(mel, exact(raw, pcen=False)) < BF16_VS_EXACT, kind
        assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel.to(torch.bfloat16))


def _train_setup(dev):
    from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
    from audio_training_tpu_torch.train import create_train_state

    cfg = FeaturizerConfig()
    model = build_model("badwinner2", 7, logits_only=True,
                        dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).module
    state = create_train_state(model, learning_rate=1e-3, device=dev)
    rng = np.random.default_rng(0)
    raw, raw2 = (rng.uniform(-0.5, 0.5, (2, 144000)).astype(np.float32)
                 for _ in range(2))
    y = np.eye(7, dtype=np.float32)[[1, 3]]
    pre = make_preprocess_fn(cfg, augment=True, device=dev)
    return state, pre, (raw, y, raw2, y[::-1].copy())


@pytest.mark.gpu
def test_train_step_launches_the_bf16_tier_kernel():
    from audio_training_tpu_torch.train import fresh_metrics, make_train_step

    dev = _card()
    state, pre, batch = _train_setup(dev)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    ffz.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    mel, yy = pre(*batch, gen)
    assert mel.shape == (2, 160, 513, 1) and mel.dtype == torch.float32
    state, m = make_train_step()(state, fresh_metrics(dev), mel, yy, gen)
    torch.cuda.synchronize()
    assert ffz.launch_counts()["fused_featurizer_mel_bf16"] == 1
    assert ffz.launch_counts()["fused_featurizer_mel"] == 0
    assert np.isfinite(float(m["loss_sum"]))
    after = state.model.state_dict()
    assert not torch.equal(after["convs.0.weight"], before["convs.0.weight"])
    assert not torch.equal(after["bns.0.running_mean"],
                           before["bns.0.running_mean"])


@pytest.mark.gpu
def test_preprocess_raises_when_the_kernel_is_refused(monkeypatch):
    """A failed launch surfaces as an error: no plain fallback on CUDA."""
    dev = _card()
    _, pre, batch = _train_setup(dev)

    class Refused:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(ffz, "_library", Refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        pre(*batch, torch.Generator(device=dev).manual_seed(0))


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


@pytest.mark.gpu
@pytest.mark.parametrize("batch,samples", [
    (3, 144000),  # production window: 513 frames in either framing
    (1, 28100),   # 100 hops: 101 centered frames, 100 tf frames
    (2, 20000),
])
def test_centered_kernel_matches_plain(batch, samples):
    dev = _card()
    fz = ffz.FusedFeaturizer(build_mel_weights(FeaturizerConfig()), center=True,
                             device=dev)
    raw = torch.from_numpy(np.random.default_rng(samples).standard_normal(
        (batch, samples)).astype(np.float32)).to(dev)
    ffz.reset_launch_counts()
    mel = fz(raw, pcen=False)
    want = ffz.fused_featurizer_plain(raw, fz.mel_weights, 281, center=True)
    assert mel.shape == want.shape == (batch, 160, 1 + samples // 281)
    assert _rel(mel, want) < MEL_REL
    assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                       mel.to(torch.bfloat16))
    got = fz(raw, pcen=True)
    assert (got - pcen(want, *fz.pcen_params, time_axis=2)).abs().max() < PCEN_ABS
    assert ffz.launch_counts() == {"fused_featurizer_mel": 0,
                                   "fused_featurizer_mel_centered": 3,
                                   "fused_featurizer_mel_bf16": 0,
                                   "fused_featurizer_mel_bf16x3": 0,
                                   "fused_featurizer_pcen": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("batch,frames,bins,mels", [
    (2, 513, 1025, 160),  # the Predictor's n_fft=2048 shape, its mel bank
    (3, 37, 129, 20),     # ragged in every dimension
    (1, 100, 257, 200),   # more mels than one block's 160 columns
])
def test_power_mel_kernel_matches_plain(batch, frames, bins, mels):
    dev = _card()
    rng = np.random.default_rng(bins)
    if bins == 1025:
        w = build_mel_weights(FeaturizerConfig(n_fft=2048))
    else:
        w = rng.random((mels, bins)).astype(np.float32)
    w_t = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)
    re, im = (torch.from_numpy(rng.standard_normal(
        (batch, frames, bins)).astype(np.float32)).to(dev) for _ in range(2))
    melspec.reset_launch_counts()
    got = melspec.fused_power_mel(re, im, w_t)
    want = melspec.power_mel_plain(re, im, w_t)
    assert got.shape == (batch, frames, mels)
    assert _rel(got, want) < MEL_REL
    spec = torch.complex(re, im)
    assert torch.equal(melspec.fused_power_mel_complex(spec, w_t), got)
    assert melspec.launch_counts() == {"power_mel": 2}
    with pytest.raises(ValueError, match="contiguous"):
        melspec.fused_power_mel_complex(spec.transpose(1, 2).contiguous()
                                        .transpose(1, 2), w_t)


def _predictor(n_fft, dev):
    cfg = FeaturizerConfig(n_fft=n_fft)
    model = build_model("badwinner2", 7, logits_only=True,
                        generator=torch.Generator().manual_seed(0)).module
    return Predictor(model.to(dev), list("abcdefg"), cfg, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft", [4096, 2048])
def test_predictor_kernel_path_matches_plain_featurizer(n_fft):
    dev = _card()
    pred = _predictor(n_fft, dev)
    windows = np.random.default_rng(n_fft).uniform(
        -0.5, 0.5, (3, 144000)).astype(np.float32)
    ffz.reset_launch_counts()
    melspec.reset_launch_counts()
    got = pred.predict_windows(windows)
    k1 = ffz.launch_counts()["fused_featurizer_mel_centered"]
    k2 = melspec.launch_counts()["power_mel"]
    assert (k1, k2) == ((1, 0) if n_fft == 4096 else (0, 1))
    raw = torch.from_numpy(windows).to(dev)
    mel = mel_power(normalize_rows(raw),
                    torch.from_numpy(build_mel_weights(pred.cfg)).to(dev),
                    n_fft, 281, center=True)
    with torch.no_grad():
        want = pred.classify(mel).cpu().numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft", [4096, 2048])
def test_predictor_raises_when_a_kernel_is_refused(monkeypatch, n_fft):
    """A failed launch surfaces as an error: no plain fallback on CUDA."""
    dev = _card()
    pred = _predictor(n_fft, dev)

    class Refused:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(ffz, "_library", Refused)
    monkeypatch.setattr(melspec, "_library", Refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        pred.predict_windows(np.ones((2, 144000), np.float32))


X3_REL = 2e-5
X3_VS_EXACT = 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("batch,samples,hop", [
    (3, 144000, 281),  # production clip: 513 frames, a 1-frame last tile
    (1, 30000, 313),
])
def test_bf16_3x_tier_kernel_matches_plain(batch, samples, hop):
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, 4096, hop, precision="bf16_3x", device=dev)
    manual = ffz.FusedFeaturizer(w, 4096, hop, precision="bf16_3x_manual",
                                 device=dev)
    exact = ffz.FusedFeaturizer(w, 4096, hop, device=dev)
    for raw in (_tone_clips(batch, samples, hop),
                normalize_rows(torch.from_numpy(np.random.default_rng(
                    hop).standard_normal((batch, samples)).astype(
                        np.float32)))):
        raw = raw.to(dev)
        ffz.reset_launch_counts()
        mel = fz(raw, pcen=False)
        assert ffz.launch_counts()["fused_featurizer_mel_bf16x3"] == 1
        want = ffz.fused_featurizer_plain(raw, fz.mel_weights, hop,
                                          precision="bf16_3x")
        assert mel.shape == want.shape == (batch, 160, -(-samples // hop))
        assert _rel(mel, want) < X3_REL
        assert _rel(mel, exact(raw, pcen=False)) < X3_VS_EXACT
        assert torch.equal(manual(raw, pcen=False), mel)
        assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel.to(torch.bfloat16))
        got = fz(raw, pcen=True)
        assert (got - pcen(want, *fz.pcen_params, time_axis=2)).abs().max() < PCEN_ABS


def _mobilenet(dev, dtype=None):
    return build_model("mobilenet", 7, logits_only=True,
                       external_frontend=True, dtype=dtype,
                       generator=torch.Generator().manual_seed(0)
                       ).module.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("tier,counter", [
    ("default", "fused_featurizer_mel_bf16"),
    ("bf16_3x", "fused_featurizer_mel_bf16x3"),
    ("bf16_3x_manual", "fused_featurizer_mel_bf16x3"),
    ("highest", "fused_featurizer_mel"),
])
def test_mobilenet_chain_launches_its_tier_kernel(tier, counter):
    dev = _card()
    infer = make_fused_infer_fn(_mobilenet(dev, torch.bfloat16),
                                FeaturizerConfig(), use_pcen=True, channels=3,
                                precision=tier, device=dev,
                                out_dtype=torch.bfloat16)
    raw = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 144000)).astype(np.float32)).to(dev)
    ffz.reset_launch_counts()
    logits = infer(raw)
    torch.cuda.synchronize()
    want = {k: 0 for k in ffz.launch_counts()}
    want[counter] = want["fused_featurizer_pcen"] = 1
    assert ffz.launch_counts() == want
    assert logits.shape == (2, 7) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_mobilenet_kernel_path_matches_plain_featurizer():
    dev = _card()
    cfg = FeaturizerConfig()
    model = _mobilenet(dev)
    raw = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 144000)).astype(np.float32)).to(dev)

    def logits(precision="highest", use_kernel=True, m=model, channels=3):
        return make_fused_infer_fn(m, cfg, use_pcen=True, channels=channels,
                                   precision=precision, use_kernel=use_kernel,
                                   device=dev)(raw)

    hi = logits()
    assert _rel(hi, logits(use_kernel=False)) < 1e-4
    assert _rel(logits("bf16_3x"), hi) < 1e-4
    assert _rel(logits(m=fold_gray_stem(model), channels=1), hi) < 1e-5
