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
1e-5; the power-mel band walk on the mel banks of n_fft 512 / 1024 / 2048 x
64 / 128 / 160 mels x FMAX 11 kHz / sr/2 as the dense plain version; the
exact kernel's four fold instances at left_pad 0 and 2048, f32 and bf16,
as the plain version (its normalize fold bitwise the unfolded kernel on
normalize_rows' clips); K1's folds at each tier as the tier's unfolded kernel (the "default"
tier's flip-free impulse check with the frontend fold alone: the normalize
fold makes every sample in the clip non-zero), the folded badwinner2 chain's
f32 logits within 1e-4 of max |logit| of the unfused chain's; the probe's
K3 within 1e-5 of max |out| (5e-5 in "accum", whose units meet through
atomics) and K4 bitwise, also where rows and lanes split unevenly over
its blocks; the PCEN kernel at its edge cases (smooth 0 / 0.04 / 1, 1 to
7,300 frames, 15 rows) within 1e-4 after the global min-max, and from a
mel off the 16-byte grid bitwise as from an aligned copy.  TF32 is off
for the plain versions' einsums and the CNN.
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
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts.update(fused_featurizer_mel=5, fused_featurizer_pcen=3)
    assert ffz.launch_counts() == want_counts


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
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts.update(fused_featurizer_mel_centered=3,
                       fused_featurizer_pcen=1)
    assert ffz.launch_counts() == want_counts


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


@pytest.mark.gpu
@pytest.mark.parametrize("fmax", [11000.0, 24000.0])  # up to sr / 2
@pytest.mark.parametrize("n_mels", [64, 128, 160])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_power_mel_band_walk_matches_plain(n_fft, n_mels, fmax):
    """The band walk over the mel bank of each geometry, on 3 x 37 rows (a
    ragged last tile), through both entries and a complex64 tensor whose
    address is 8 bytes off the 16-byte grid."""
    dev = _card()
    w = build_mel_weights(FeaturizerConfig(n_fft=n_fft, n_mels=n_mels,
                                           fmax=fmax))
    w_t = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)
    rng = np.random.default_rng(n_fft + n_mels)
    re, im = (torch.from_numpy(rng.standard_normal(
        (3, 37, w.shape[1])).astype(np.float32)).to(dev) for _ in range(2))
    melspec.reset_launch_counts()
    got = melspec.fused_power_mel(re, im, w_t)
    want = melspec.power_mel_plain(re, im, w_t)
    assert got.shape == (3, 37, n_mels)
    assert _rel(got, want) < MEL_REL
    spec = torch.complex(re, im)
    assert torch.equal(melspec.fused_power_mel_complex(spec, w_t), got)
    shifted = torch.empty(spec.numel() + 1, dtype=torch.complex64,
                          device=dev)[1:].view(spec.shape)
    shifted.copy_(spec)
    assert shifted.data_ptr() % 16 == 8
    assert torch.equal(melspec.fused_power_mel_complex(shifted, w_t), got)
    assert melspec.launch_counts() == {"power_mel": 3}


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


# ---- K1's folds and centered tensor-core tiers, the folded chain --------

X3_REL_TIERS = {"highest": MEL_REL, "bf16_3x": X3_REL}


def _frontend_params(seed=0):
    rng = np.random.default_rng(seed)
    return (np.float32(-0.7), rng.normal(1.0, 0.3, 160).astype(np.float32),
            rng.uniform(0.5, 2.0, 160).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("samples", [144000, 30001, 3])
def test_clip_minmax_kernel_matches_plain(samples):
    """The normalize fold's per-clip (min, max - min), bitwise its plain
    version."""
    dev = _card()
    raw = torch.from_numpy(np.random.default_rng(samples).standard_normal(
        (5, samples)).astype(np.float32)).to(dev)
    ffz.reset_launch_counts()
    got = ffz.clip_minmax(raw)
    assert ffz.launch_counts()["clip_minmax"] == 1
    assert torch.equal(got, ffz.clip_minmax_plain(raw))


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["highest", "default", "bf16_3x"])
@pytest.mark.parametrize("fold", ["normalize", "frontend", "both"])
def test_folded_kernels_match_plain(tier, fold):
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, precision=tier, device=dev)
    kw = {}
    if fold != "frontend":
        kw["normalize_waveform"] = True
    if fold != "normalize":
        kw["frontend_params"] = _frontend_params()
    frontend = (None if fold == "normalize" else
                ffz.frontend_tables(kw["frontend_params"], 160, dev))
    rng = np.random.default_rng(3)
    raw = torch.from_numpy((0.3 * rng.standard_normal((3, 144000)) + 0.2)
                           .astype(np.float32)).to(dev)
    if fold == "frontend":
        raw = normalize_rows(raw)
    ffz.reset_launch_counts()
    got = fz(raw, pcen=False, **kw)
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts[ffz.mel_counter(tier, folded=True)] = 1
    want_counts["clip_minmax"] = int(fold != "frontend")
    assert ffz.launch_counts() == want_counts
    want = ffz.fused_featurizer_plain(
        raw, fz.mel_weights, 281, precision=tier,
        normalize_waveform=fold != "frontend", frontend=frontend)
    assert got.shape == want.shape == (3, 160, 513)
    if tier == "default":
        assert _rms_rel(got, want) < BF16_RMS_REL
        assert _rel(got, want) < BF16_STEP
    else:
        assert _rel(got, want) < X3_REL_TIERS[tier]
    assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16, **kw),
                       got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("fold", ["none", "normalize", "frontend", "both"])
def test_exact_kernel_instances_match_plain(fold, center, out_dtype):
    """Each of mel_power_kernel's four fold instances at left_pad 0 and
    2048, f32 or bf16 out, against fused_featurizer_plain (the folds with
    the centered framing are no entry of the class, JAX's contract, so
    that instance is launched through ``_launch``); the normalize fold's
    output bitwise the unfolded kernel's on normalize_rows' clips."""
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, center=center, device=dev)
    norm = fold in ("normalize", "both")
    fp = _frontend_params(2) if fold in ("frontend", "both") else None
    frontend = None if fp is None else ffz.frontend_tables(fp, 160, dev)
    rng = np.random.default_rng(7)
    raw = torch.from_numpy((0.3 * rng.standard_normal((3, 144000)) + 0.2)
                           .astype(np.float32)).to(dev)
    if not norm:
        raw = normalize_rows(raw)
    ffz.reset_launch_counts()
    got = fz._launch(raw, None, out_dtype, norm, frontend)
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts[ffz.mel_counter("highest", center, fold != "none")] = 1
    want_counts["clip_minmax"] = int(norm)
    assert ffz.launch_counts() == want_counts
    want = ffz.fused_featurizer_plain(
        raw, fz.mel_weights, 281, center=center, normalize_waveform=norm,
        frontend=frontend)
    frames = 1 + 144000 // 281 if center else 513
    assert got.shape == want.shape == (3, 160, frames)
    assert got.dtype == out_dtype
    if out_dtype == torch.float32:
        assert _rel(got, want) < MEL_REL
        if norm:
            assert torch.equal(got, fz._launch(normalize_rows(raw), None,
                                               out_dtype, False, frontend))
    else:
        f32 = fz._launch(raw, None, torch.float32, norm, frontend)
        assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.gpu
def test_frontend_fold_on_impulses_is_flip_free():
    """With the frontend fold alone the "default" tier's mel is the
    impulse input's: no rounding can flip, so kernel and plain version agree
    as the unfolded tier does."""
    dev = _card()
    fz = ffz.FusedFeaturizer(build_mel_weights(FeaturizerConfig()),
                             precision="default", device=dev)
    fp = _frontend_params(1)
    raw = _impulses(3, 144000, 5).to(dev)
    got = fz(raw, pcen=False, frontend_params=fp)
    want = ffz.fused_featurizer_plain(
        raw, fz.mel_weights, 281, precision="default",
        frontend=ffz.frontend_tables(fp, 160, dev))
    assert _rel(got, want) < BF16_FLIP_FREE_REL


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["default", "bf16_3x"])
@pytest.mark.parametrize("batch,samples", [(7, 144000), (4, 28100),
                                           (1, 144000), (9, 30000)])
def test_tensor_core_tiers_pad_their_clusters(tier, batch, samples):
    """Blocks run in clusters of TC_CLUSTER clips: at a batch the cluster
    does not divide, the padding blocks take part and store nothing.  The
    tier against its plain version (tf framing, the short clip's 4-frame
    last block too), one launch; each clip's mel bitwise the same as in a
    batch one larger (no padding block writes into the output)."""
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, precision=tier, device=dev)
    raw = normalize_rows(torch.from_numpy(np.random.default_rng(
        batch).standard_normal((batch + 1, samples)).astype(
            np.float32))).to(dev)
    ffz.reset_launch_counts()
    got = fz(raw[:batch], pcen=False)
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts[ffz.mel_counter(tier)] = 1
    assert ffz.launch_counts() == want_counts
    want = ffz.fused_featurizer_plain(raw[:batch], fz.mel_weights, 281,
                                      precision=tier)
    assert got.shape == want.shape == (batch, 160, -(-samples // 281))
    if tier == "default":
        assert _rms_rel(got, want) < BF16_RMS_REL
        assert _rel(got, want) < BF16_STEP
    else:
        assert _rel(got, want) < X3_REL
    assert torch.equal(fz(raw, pcen=False)[:batch], got)
    assert torch.equal(fz(raw[:batch], pcen=False, out_dtype=torch.bfloat16),
                       got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["default", "bf16_3x"])
@pytest.mark.parametrize("n_mels", [64, 256])
def test_tensor_core_tiers_take_any_bank(tier, n_mels):
    """Other banks than the production one, 256 mels among them (half 0's
    partial mels of "bf16_3x" live in a global scratch that grows with
    n_mels): the tier against its plain version, f32 and bf16 out."""
    dev = _card()
    w = build_mel_weights(FeaturizerConfig(n_mels=n_mels))
    fz = ffz.FusedFeaturizer(w, precision=tier, device=dev)
    raw = normalize_rows(torch.from_numpy(np.random.default_rng(
        n_mels).standard_normal((5, 30000)).astype(np.float32))).to(dev)
    got = fz(raw, pcen=False)
    want = ffz.fused_featurizer_plain(raw, fz.mel_weights, 281,
                                      precision=tier)
    assert got.shape == want.shape == (5, n_mels, -(-30000 // 281))
    if tier == "default":
        assert _rms_rel(got, want) < BF16_RMS_REL
        assert _rel(got, want) < BF16_STEP
    else:
        assert _rel(got, want) < X3_REL
    assert torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                       got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["default", "bf16_3x"])
def test_tensor_core_launch_config(tier):
    """Clusters of TC_CLUSTER blocks of 9 warps (8 compute warps and the
    ring's producer) that fit the block's shared memory and the card."""
    _card()
    cfg = ffz.tc_launch_config(tier)
    assert cfg["cluster"] == ffz.TC_CLUSTER and cfg["threads"] == 288
    assert 200_000 < cfg["smem_bytes"] <= 232_448
    assert cfg["active_clusters"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["default", "bf16_3x", "bf16_3x_manual"])
@pytest.mark.parametrize("batch,samples", [(3, 144000), (1, 28100),
                                           (2, 20000)])
def test_centered_tensor_core_tiers_match_plain(tier, batch, samples):
    dev = _card()
    w = build_mel_weights(FeaturizerConfig())
    fz = ffz.FusedFeaturizer(w, precision=tier, center=True, device=dev)
    raw = normalize_rows(torch.from_numpy(np.random.default_rng(
        samples).standard_normal((batch, samples)).astype(np.float32))).to(dev)
    ffz.reset_launch_counts()
    got = fz(raw, pcen=False)
    want_counts = dict.fromkeys(ffz.launch_counts(), 0)
    want_counts[ffz.mel_counter(tier, center=True)] = 1
    assert ffz.launch_counts() == want_counts
    want = ffz.fused_featurizer_plain(raw, fz.mel_weights, 281, center=True,
                                      precision=tier)
    assert got.shape == want.shape == (batch, 160, 1 + samples // 281)
    if tier == "default":
        assert _rms_rel(got, want) < BF16_RMS_REL
        assert _rel(got, want) < BF16_STEP
    else:
        assert _rel(got, want) < X3_REL
    exact = ffz.FusedFeaturizer(w, center=True, device=dev)(raw, pcen=False)
    assert _rel(got, exact) < (BF16_VS_EXACT if tier == "default"
                               else X3_VS_EXACT)


@pytest.mark.gpu
def test_folded_chain_matches_the_unfused_chain():
    """K1 with both folds -> BadWinner2(external_frontend=True) against
    normalize_rows -> K1 -> BadWinner2 with its own frontend, the same
    weights, f32 logits."""
    dev = _card()
    cfg = FeaturizerConfig()
    unfused = build_model("badwinner2", 7, logits_only=True,
                          generator=torch.Generator().manual_seed(0)).module
    a, mean, var = _frontend_params(2)
    with torch.no_grad():
        unfused.mag.a_power.fill_(float(a))
        unfused.mel_bn.running_mean.copy_(torch.from_numpy(mean))
        unfused.mel_bn.running_var.copy_(torch.from_numpy(var))
    folded = build_model("badwinner2", 7, logits_only=True,
                         external_frontend=True).module
    folded.load_state_dict({k: v for k, v in unfused.state_dict().items()
                            if not k.startswith(("mag.", "mel_bn."))})
    unfused, folded = unfused.to(dev).eval(), folded.to(dev).eval()
    fz = ffz.FusedFeaturizer(build_mel_weights(cfg), device=dev)
    raw = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 144000)).astype(np.float32)).to(dev)
    with torch.no_grad():
        got = folded(fz(raw, pcen=False, normalize_waveform=True,
                        frontend_params=(a, mean, var))[..., None])
        want = unfused(fz(normalize_rows(raw), pcen=False)[..., None])
    assert _rel(got, want) < 1e-4


# ---- the megakernel probe (K3, K4) -----------------------------------------

DOT_REL = {"store": 1e-5, "brot": 1e-5, "accum": 5e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["store", "accum", "brot"])
@pytest.mark.parametrize("m,k,n,ndots,grid", [
    (64, 640, 512, 9, 2),     # 144 dot-tiles: one or two a block
    (64, 640, 512, 512, 8),   # the probe's first shape
    (128, 128, 128, 17, 3),
    (64, 64, 256, 40, 1),
    (64, 768, 128, 13, 2),    # k = 768; ndots not a multiple of 4 or 8
    (512, 640, 128, 10, 1),   # m = 512 with n = 128; grid 1
    (64, 640, 128, 300, 1),   # runs of (j, tile) cut into 4-5 dot units
    (64, 1024, 128, 9, 2),    # k past one fill: phases of 896 and 128
    (128, 2048, 128, 6, 1),   # three phases
])
def test_dot_probe_kernel_matches_plain(mode, m, k, n, ndots, grid):
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    dev = _card()
    a, b = pm.dot_inputs(m, k, n, mode, dev)
    pm.reset_launch_counts()
    got = pm.dot_probe(0.5, a, b, ndots, grid, mode)
    torch.cuda.synchronize()
    assert pm.launch_counts()[f"probe_dot_{mode}"] == 1
    want = pm.dot_probe_plain(0.5, a, b, ndots, grid, mode)
    assert got.shape == want.shape == (8 * grid, 128)
    assert _rel(got, want) < DOT_REL[mode]


def _dot_scratch_plain(a, b, ndots, grid, mode):
    """What the kernel leaves in its whole scratch, computed plainly:
    "store"/"brot" (grid, 8, m, n), slot r the last d_i with i % 8 == r
    (slots past ndots unwritten, None); "accum" the (grid, m, n) sums."""
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    af, bf = a.float(), b.float()
    idx = torch.arange(ndots, device=a.device) % 4
    prods = (torch.matmul(af[0], bf[idx]) if mode == "brot"
             else torch.matmul(af[idx], bf))
    if mode == "accum":
        acc = torch.full(prods.shape[1:], 0.5 * 1e-30, device=a.device)
        for d in prods:
            acc = acc + d
        return acc.expand(grid, *acc.shape)
    last = [max(i for i in range(ndots) if i % pm.SLOTS == r)
            if r < ndots else None for r in range(pm.SLOTS)]
    return [prods[i] if i is not None else None for i in last]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["store", "accum", "brot"])
@pytest.mark.parametrize("m,k,n,ndots,grid", [
    (128, 640, 192, 13, 2),   # every row of the fragment, tiles tm, tn > 0
    (192, 1024, 128, 6, 1),   # two k phases; slots 6, 7 unwritten
])
def test_dot_probe_kernel_scratch_matches_plain(mode, m, k, n, ndots, grid):
    """Every element the kernel writes, not only the (8, 128) output: each
    slot's d_i in "store"/"brot", in "accum" the sums (the scratch outside
    the output block, the output inside it), at the same limits."""
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    dev = _card()
    a, b = pm.dot_inputs(m, k, n, mode, dev)
    out, scratch = pm._dot_launch(0.5, a, b, ndots, grid, mode)
    torch.cuda.synchronize()
    want = _dot_scratch_plain(a, b, ndots, grid, mode)
    if mode == "accum":
        got = scratch.clone()
        got[:, :8, :128] += out.reshape(grid, 8, 128)
        assert _rel(got, want) < DOT_REL[mode]
        return
    for g in range(grid):
        for r, w in enumerate(want):
            if w is not None:
                assert _rel(scratch[g, r], w) < DOT_REL[mode], (g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 1000, 128), (64, 96, 128),
                                   (100, 640, 128), (64, 640, 160)])
def test_dot_probe_kernel_refuses_what_it_does_not_take(m, k, n):
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    dev = _card()
    a, b = pm.dot_inputs(m, k, n, "store", dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        pm.dot_probe(0.5, a, b, 9, 1, "store")


@pytest.mark.gpu
@pytest.mark.parametrize("mode,m,lanes", [
    ("shift1", 64, 640), ("roll", 64, 640), ("roll", 16, 130),
    ("pool3", 64, 640), ("copyblk", 256, 128), ("copyblk", 16, 128)])
def test_shift_probe_kernel_matches_plain(mode, m, lanes):
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    dev = _card()
    x = pm.shift_input(m, lanes, dev)
    pm.reset_launch_counts()
    got = pm.shift_probe(0.25, x, 7, 3, mode)
    assert pm.launch_counts()[f"probe_shift_{mode}"] == 1
    assert torch.equal(got, pm.shift_probe_plain(0.25, x, 7, 3, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,m,lanes,grid", [
    ("shift1", 8, 513, 1), ("shift1", 72, 513, 3), ("roll", 8, 130, 1),
    ("roll", 72, 130, 3), ("roll", 72, 513, 3), ("pool3", 8, 507, 1),
    ("pool3", 72, 513, 3), ("copyblk", 8, 130, 1), ("copyblk", 72, 130, 3)])
def test_shift_probe_kernel_splits_rows_unevenly(mode, m, lanes, grid):
    """K4 where rows and lanes fall unevenly over warps and blocks (130
    lanes: a partial last quad; 72 rows: a partial last block) and at one
    and three steps, bitwise its plain version."""
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    dev = _card()
    x = pm.shift_input(m, lanes, dev)
    got = pm.shift_probe(0.25, x, 9, grid, mode)
    assert torch.equal(got, pm.shift_probe_plain(0.25, x, 9, grid, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("smooth", [0.0, 0.04, 1.0])
@pytest.mark.parametrize("frames", [1, 33, 513, 1000, 7300])
def test_pcen_kernel_edge_cases(frames, smooth):
    """The PCEN kernel on 15 rows (not a multiple of a block's 8) of mel
    power, at smooth 0 (d = 1) and 1 (d = 0), one frame, one frame past a
    run, one chunk, two chunks and 14 (7,300 frames: 29 KB a row, more
    than a block's 8 rows would fit in shared memory at once): within 1e-4
    of the plain version after PCEN's global min-max, its bf16 output
    bitwise the f32 cast."""
    from audio_training_tpu_torch.ops.pcen import normalize_minmax_global

    dev = _card()
    rng = np.random.default_rng(frames)
    mel = np.exp(rng.normal(-4.0, 2.0, (3, 5, frames))).astype(np.float32)
    mel = torch.from_numpy(mel).to(dev)
    params = (0.98, 2.0, 2.0, smooth, 1e-6)
    ffz.reset_launch_counts()
    got = ffz.pcen_rows(mel, params)
    assert ffz.launch_counts()["fused_featurizer_pcen"] == 1
    want = pcen(mel, *params, time_axis=2, normalize=False)
    err = (normalize_minmax_global(got) - normalize_minmax_global(want))
    assert err.abs().max() < PCEN_ABS
    assert torch.equal(ffz.pcen_rows(mel, params, torch.bfloat16),
                       got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_pcen_kernel_takes_an_unaligned_mel(offset):
    """A mel view 4, 8 or 12 bytes past a 16-byte boundary: the kernel
    stages each chunk from its own phase, bitwise as from an aligned copy."""
    dev = _card()
    base = torch.rand(160 * 513 + offset, device=dev)
    mel = base[offset:].view(1, 160, 513)
    assert mel.data_ptr() % 16 == 4 * offset
    params = (0.98, 2.0, 2.0, 0.04, 1e-6)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(ffz.pcen_rows(mel, params, dtype),
                           ffz.pcen_rows(mel.clone(), params, dtype))


@pytest.mark.gpu
def test_batch_loader_device_batches_equal_the_host_arrays():
    """The BatchLoader's producer thread pins each batch and copies it on a
    side stream; the consumer's stream waits on the copy and keeps the
    batch's memory from reuse until its reads are done.  Over 50 batches
    (mixup partner and lat/lng included), each read by a device copy
    queued behind a step's worth of work on the consumer's stream, every
    batch equals its host arrays byte for byte."""
    from audio_training_tpu_torch.data.pipeline import BatchLoader

    dev = _card()
    batches, b, n, labels = 50, 16, 144000, 62
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal(n, dtype=np.float32),
              rng.random(labels, dtype=np.float32),
              rng.random(2, dtype=np.float32))
             for _ in range(2 * b * batches)]
    main, partner = items[::2], items[1::2]
    loader = BatchLoader(iter(main), b, labels, n, mix_stream=iter(partner),
                         device=dev)
    w = torch.randn(4096, 4096, device=dev)
    x = torch.randn(4096, 4096, device=dev)
    reads = []
    for batch in loader:
        for _ in range(8):  # a step's worth of work ahead of the reads
            x = torch.tanh(x @ w)
        reads.append(tuple(t.clone() for t in batch))
        del batch
    torch.cuda.synchronize()
    assert len(reads) == batches
    for i, (raw, y, raw2, y2, latlng) in enumerate(reads):
        rows = slice(i * b, (i + 1) * b)
        want = (np.stack([m[0] for m in main[rows]]),
                np.stack([m[1] for m in main[rows]]),
                np.stack([m[0] for m in partner[rows]]),
                np.stack([m[1] for m in partner[rows]]),
                np.stack([m[2] for m in main[rows]]))
        for got, host in zip((raw, y, raw2, y2, latlng), want):
            assert got.device.type == "cuda"
            assert np.array_equal(got.cpu().numpy(), host), i
