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
1e-5, and the same of EfficientNetV2-B3 (whose fold is refused with its
baked preprocessing); the other families' chains with their launch counts; the power-mel band walk on the mel banks of n_fft 512 / 1024 / 2048 x
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

Train-mode BatchNorm's kernels (``ops/cuda/batch_norm.py``) against their
plain version (``KerasBatchNorm.train_plain``) on the same CUDA input, the
two differing in the order of their f32 sums only: bf16 outputs (y, dx)
compared in bf16, within one bf16 step of the tensor's max (2^-7) and with
at most 1% of the values off (a reordered sum flips a rounding to bf16 now
and then); f32 outputs (y, dx of the f32 layouts) and the running
statistics within 1e-5 of the tensor's max; the parameter gradients (f32
sums over every row) within 1e-4 of their max.  Two runs of the kernels on
one input are bitwise equal (no atomics).  Under a mesh of two ranks on
the card (gloo), the kernels on each rank's half of the batch against one
process of the same kernels on the whole batch, which differ in the order
of their f32 sums alone, at the same limits: y and dx of the rows, the two
ranks' parameter gradients summed, each rank's running statistics, and
each rank's launches (two statistics finalizes: the local sums, then the
all-reduced ones).

The eval conv epilogue (``ops/cuda/conv_epilogue.py``) against its plain
version on the same input, at the BatchNorm kernels' limits (the two differ
in f32 rounding order and SiLU's exponential): bf16 and f32, residual on
and off, channels-last and C-in-the-middle layouts, badwinner2's and B3's
channel counts and odd ones, off the 16-byte grid, each launch counted
under its kernel; its refusals, counted as no launch; eval badwinner2 and
B3 forwards on the card counting 7 and 87 kernel epilogues under no_grad
and none with a gradient recorded (their f32 logits within 1e-4 of the max
of each other), an fp16 eval forward raising, a training step none.
"""

import copy

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


def _family(name, dev, dtype=None, **kw):
    return build_model(name, 7, logits_only=True, dtype=dtype,
                       generator=torch.Generator().manual_seed(0),
                       **kw).module.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,counters", [
    ("efficientnetv2b3", {"external_frontend": True},
     ("fused_featurizer_mel_bf16", "fused_featurizer_pcen")),
    ("inceptionv3", {"external_frontend": True},
     ("fused_featurizer_mel_bf16", "fused_featurizer_pcen")),
    ("wr-resnet-bird", {}, ("fused_featurizer_mel",)),
    ("badwinner2-res", {}, ("fused_featurizer_mel",)),
])
def test_model_family_chain_launches_its_kernels(name, kw, counters):
    """A backbone behind K1's "default" tier and PCEN epilogue, a mel
    family behind K1's exact tier with its own frontend; bf16 CNNs."""
    dev = _card()
    mel = not kw
    infer = make_fused_infer_fn(
        _family(name, dev, torch.bfloat16, **kw), FeaturizerConfig(),
        use_pcen=not mel, channels=1 if mel else 3,
        precision="highest" if mel else "default", device=dev,
        out_dtype=torch.float32 if mel else torch.bfloat16)
    raw = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 144000)).astype(np.float32)).to(dev)
    ffz.reset_launch_counts()
    logits = infer(raw)
    torch.cuda.synchronize()
    want = {k: 0 for k in ffz.launch_counts()}
    want.update({c: 1 for c in counters})
    assert ffz.launch_counts() == want
    assert logits.shape == (2, 7) and bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_efficientnetv2b3_kernel_path_matches_plain_featurizer():
    """f32 logits of the kernel path within 1e-4 of the plain featurizer's;
    the fold refused with the baked preprocessing, and without it the
    folded 1-channel stem within 1e-5 of the 3-channel repeat."""
    dev = _card()
    cfg = FeaturizerConfig()
    model = _family("efficientnetv2b3", dev, external_frontend=True)
    raw = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 144000)).astype(np.float32)).to(dev)

    def logits(m, use_kernel=True, channels=3):
        return make_fused_infer_fn(m, cfg, use_pcen=True, channels=channels,
                                   use_kernel=use_kernel, device=dev)(raw)

    assert _rel(logits(model), logits(model, use_kernel=False)) < 1e-4
    with pytest.raises(ValueError, match="EfficientNetV2"):
        fold_gray_stem(model)
    plain = _family("efficientnetv2b3", dev, external_frontend=True,
                    backbone_args=(("preprocess", False),))
    assert _rel(logits(fold_gray_stem(plain), channels=1),
                logits(plain)) < 1e-5


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


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 128)])
def test_spectral_gate_on_the_card_matches_the_cpu(n_fft, hop):
    """``--denoise``'s spectral gate (plain PyTorch: STFT, stable argsort,
    population std, mask, ``F.fold`` overlap-add) on a 60 s recording at
    48 kHz, on the card as on the CPU, within 1e-5 of max |x|."""
    from audio_training_tpu_torch.ops.denoise import spectral_gate

    dev = _card()
    rng = np.random.default_rng(n_fft)
    t = np.arange(48000 * 60) / 48000
    x = 0.05 * rng.standard_normal((2, t.size))
    x += np.sin(2 * np.pi * 2000 * t) * (t % 2.0 < 1.2)
    x = torch.from_numpy(x.astype(np.float32))
    want = spectral_gate(x, n_fft, hop)
    got = spectral_gate(x.to(dev), n_fft, hop)
    assert got.device.type == "cuda"
    assert _rel(got.cpu(), want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("view", [0, 1])
@pytest.mark.parametrize("batch", [2, 8])
def test_power_mel_kernel_on_the_dual_view_banks(view, batch):
    """K2 on dual-badwinner2's band-masked banks (2048/278 with (1025, 160),
    1024/280 with (513, 160), production geometry) as its plain version,
    each view's launch counted once."""
    from audio_training_tpu_torch.data.preprocess import make_dual_mel
    from audio_training_tpu_torch.ops.stft import stft_tf_style

    dev = _card()
    bank_t, n_fft, hop = make_dual_mel(FeaturizerConfig(), device=dev).views[
        view]
    raw = normalize_rows(torch.from_numpy(np.random.default_rng(batch)
                                          .standard_normal((batch, 144000))
                                          .astype(np.float32)).to(dev))
    spec = stft_tf_style(raw, n_fft, hop)
    melspec.reset_launch_counts()
    got = melspec.fused_power_mel_complex(spec, bank_t)
    assert melspec.launch_counts()["power_mel"] == 1
    want = melspec.power_mel_plain(spec.real, spec.imag, bank_t)
    assert got.shape == (batch, (518, 515)[view], 160)
    assert _rel(got, want) < MEL_REL


@pytest.mark.gpu
def test_dual_preprocess_on_the_card_matches_the_cpu():
    """make_preprocess_fn(dual=True) on the card (STFT + K2 a view) as on
    the CPU (STFT + the plain version), both views within 1e-5."""
    from audio_training_tpu_torch.data.preprocess import make_preprocess_fn

    dev = _card()
    cfg = FeaturizerConfig()
    raw = np.random.default_rng(3).standard_normal((4, 144000)).astype(
        np.float32)
    y = np.eye(4, dtype=np.float32)
    melspec.reset_launch_counts()
    got, _ = make_preprocess_fn(cfg, dual=True, device=dev)(raw, y)
    assert melspec.launch_counts()["power_mel"] == 2
    want, _ = make_preprocess_fn(cfg, dual=True, device="cpu")(raw, y)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert _rel(g.cpu(), w) < MEL_REL


@pytest.mark.gpu
def test_predict_on_test_on_the_card_matches_the_cpu(tmp_path,
                                                     monkeypatch):
    """``predict_on_test`` of one run (seeded badwinner2 weights, the
    production geometry) on a pinned test split of three 8 s recordings:
    the card's confusion (centered K1, one launch a recording) equals the
    CPU's, each side under the same fixed sampling randomness."""
    import json

    from scipy.io import wavfile

    from audio_training_tpu_torch.cli.predict import load_predictor
    from audio_training_tpu_torch.infer.folder import predict_on_test
    from audio_training_tpu_torch.train.checkpoints import save_state_dict

    dev = _card()
    cfg = FeaturizerConfig()
    labels = ["kiwi", "morepo2", "tui1", "noise"]
    run = tmp_path / "run"
    model = build_model("badwinner2", len(labels), logits_only=True,
                        n_mels=cfg.n_mels,
                        generator=torch.Generator().manual_seed(3)).module
    save_state_dict(run / "val-loss.pt", model.state_dict())
    (run / "metadata.txt").write_text(json.dumps({
        "name": "badwinner2", "labels": labels, "multi_label": True}))
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(4)
    t = np.arange(8 * cfg.sr) / cfg.sr
    for i, (what, freq) in enumerate((("kiwi", 1800), ("morepork", 900),
                                      ("tui", 3000))):
        audio = (np.sin(2 * np.pi * freq * t) * (t % 2 < 1.0)
                 + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        wavfile.write(raw / f"r{i}.wav", cfg.sr, audio)
        (raw / f"r{i}.txt").write_text(json.dumps({
            "id": f"r{i}", "duration": 8.0,
            "Tracks": [{"id": i, "start": 0.5, "end": 7.0,
                        "tags": [{"what": what, "automatic": False}]}]}))
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"recs": {"test": ["r0", "r1", "r2"]}}))

    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: real(
        0 if seed is None else seed))
    cms = {}
    for device in ("cuda", "cpu"):
        pred, _ = load_predictor(run, "val-loss", device=device)
        ffz.reset_launch_counts()
        cms[device], got_labels = predict_on_test(pred, split, raw)
        if device == "cuda":
            torch.cuda.synchronize()
            assert ffz.launch_counts()["fused_featurizer_mel_centered"] == 3
    assert got_labels == labels
    assert cms["cuda"].sum() > 0
    np.testing.assert_array_equal(cms["cuda"], cms["cpu"])


def _write_debug_data(root, labels, n=12):
    """A built dataset's layout at the production geometry: ``n`` records
    of 3 s at 48 kHz (tone bursts over noise, one label each) in a train
    shard, and ``training-meta.json`` naming the labels."""
    import json

    from audio_training_tpu_torch.data import (
        SampleRecord,
        encode_sample,
        write_tfrecords,
    )

    cfg = FeaturizerConfig()
    rng = np.random.default_rng(8)
    t = np.arange(cfg.samples_per_clip) / cfg.sr
    recs = [encode_sample(SampleRecord(
        raw=(np.sin(2 * np.pi * (500 + 300 * i) * t) * (t % 1 < 0.6)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
        tags=[labels[i % len(labels)]], rec_id=f"r{i}"))
        for i in range(n)]
    write_tfrecords(root / "train" / "00-0.tfrecord", recs)
    (root / "training-meta.json").write_text(json.dumps({"labels": labels}))


@pytest.mark.gpu
def test_debug_cli_on_the_card_matches_the_cpu(tmp_path):
    """``cli/debug`` featurizes each batch with K1's exact tf tier, one
    ``mel_power_kernel`` launch a batch, and its check equals the CPU's."""
    from audio_training_tpu_torch.cli import debug

    _card()
    _write_debug_data(tmp_path, ["kiwi", "morepo2", "tui1"])
    fields = ("checked", "nan_count", "out_of_range", "constant",
              "label_counts")
    results = {}
    for device in ("cuda", "cpu"):
        args = debug.parse_args([str(tmp_path), "--batches", "2",
                                 "--batch-size", "4", "--device", device])
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        res = debug.debug_pipeline(args)
        torch.cuda.synchronize()
        counts = ffz.launch_counts()
        results[device] = {k: getattr(res, k) for k in fields}
        want = 2 if device == "cuda" else 0
        assert counts["fused_featurizer_mel"] == want
        assert sum(counts.values()) == want
    assert results["cuda"] == results["cpu"]
    assert results["cuda"]["checked"] == 8 and res.ok
    assert debug.main([str(tmp_path), "--batches", "1"]) == 0


@pytest.mark.gpu
def test_device_event_summary_finds_the_exact_kernel(tmp_path):
    """A trace of one exact-tier K1 call lists ``mel_power_kernel`` among
    the card's kernels, and the layer map ties a conv's kernels to its
    module."""
    from audio_training_tpu_torch.utils import profiling

    dev = _card()
    cfg = FeaturizerConfig()
    fz = ffz.FusedFeaturizer(build_mel_weights(cfg), cfg.n_fft,
                             cfg.hop_length, device=dev)
    raw = torch.randn(8, cfg.samples_per_clip, device=dev)
    fz(raw, pcen=False)
    with profiling.trace(tmp_path):
        fz(raw, pcen=False)
    rows = profiling.device_event_summary(tmp_path, device=0)
    names = [name for name, _ in rows]
    assert any("mel_power_kernel" in name for name in names), names
    assert all(ms > 0 for _, ms in rows)

    model = torch.nn.Sequential(torch.nn.Conv2d(1, 8, 3),
                                torch.nn.ReLU()).to(dev)
    x = torch.randn(2, 1, 32, 32, device=dev)
    lmap = profiling.fusion_layer_map(model, x, model=model)
    assert any("Sequential.0" in paths for paths in lmap.values()), lmap


@pytest.mark.gpu
def test_log_memory_stats_reports_the_card():
    from audio_training_tpu_torch.utils.profiling import log_memory_stats

    dev = _card()
    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(1 << 20, device=dev)
    stats = log_memory_stats()["cuda:0"]
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory


# ---- train-mode BatchNorm --------------------------------------------------

BN_BF16_STEP = 2.0 ** -7  # one bf16 step of the tensor's max
BN_BF16_OFF = 0.01  # share of bf16 values a flipped rounding may move
BN_F32_REL = 1e-5
BN_GRAD_REL = 1e-4
B8 = 8  # badwinner2's shapes, the batch cut from 128 for time


def _bn_case(dev, shape, feature_dim=1, dtype=torch.bfloat16,
             channels_last=True, scale=True, bias=True, seed=0,
             constant=None):
    """A train-mode KerasBatchNorm on the card, an input (per-channel
    offsets and scales, channel ``constant`` held at one value) and a
    gradient of the output."""
    from audio_training_tpu_torch.models.layers import KerasBatchNorm

    g = torch.Generator().manual_seed(seed)
    c = shape[feature_dim]
    m = KerasBatchNorm(c, feature_dim, scale, bias).to(dev).train()
    with torch.no_grad():
        if m.weight is not None:
            m.weight.copy_(torch.rand(c, generator=g) + 0.5)
        if m.bias is not None:
            m.bias.copy_(torch.rand(c, generator=g) - 0.5)
        m.running_mean.copy_(torch.rand(c, generator=g) - 0.5)
        m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    view = [1] * len(shape)
    view[feature_dim] = c
    x = (torch.randn(shape, generator=g)
         * (torch.rand(c, generator=g) * 1.5 + 0.5).view(view)
         + (torch.rand(c, generator=g) * 2 - 1).view(view))
    if constant is not None:
        x.select(feature_dim, constant).fill_(0.3)
    dy = torch.randn(shape, generator=g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x, dy = (t.to(dev, dtype).contiguous(memory_format=fmt) for t in (x, dy))
    return m, x, dy


def _bn_run(m, x, dy, plain=False):
    """y, dx, the parameter gradients and the running statistics of one
    forward and backward of a copy of ``m``: its kernels, or ``plain``."""
    m = copy.deepcopy(m)
    xr = x.detach().clone().requires_grad_()
    y = m.train_plain(xr, m.weight, m.bias) if plain else m(xr)
    params = [p for p in (m.weight, m.bias) if p is not None]
    dx, *dp = torch.autograd.grad(y, [xr, *params], dy)
    return y, dx, dp, m.running_mean, m.running_var


def _bn_close(got, want, rel):
    if got.dtype == torch.bfloat16:
        off = (got.float() - want.float()).abs()
        return bool(off.max() <= BN_BF16_STEP * want.float().abs().max()
                    and (off > 0).float().mean() <= BN_BF16_OFF)
    return _rel(got.float(), want.float()) < rel


def _bn_check(m, x, dy):
    from audio_training_tpu_torch.ops.cuda import batch_norm as bn

    bn.reset_launch_counts()
    got = _bn_run(m, x, dy)
    torch.cuda.synchronize()
    counts = bn.launch_counts()
    want = _bn_run(m, x, dy, plain=True)
    y, dx = got[0], got[1]
    assert y.dtype == dx.dtype == x.dtype
    assert y.stride() == x.stride() and dx.stride() == x.stride()
    assert _bn_close(y, want[0], BN_F32_REL)
    assert _bn_close(dx, want[1], BN_F32_REL)
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        assert _bn_close(g, w, BN_GRAD_REL)
    for g, w in zip(got[3:], want[3:]):
        assert _bn_close(g, w, BN_F32_REL)
    assert counts == dict.fromkeys(counts, 1), counts
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [
    ("bns.0", (B8, 64, 158, 511)),
    ("bns.1", (B8, 64, 156, 509)),
    ("bns.2", (B8, 128, 50, 167)),
    ("bns.3", (B8, 128, 48, 165)),
    ("bns.4 (condense)", (B8, 128, 5, 163)),
    ("the head's shape channels-last, C=1024", (B8, 1024, 1, 46)),
])
def test_batch_norm_kernels_at_badwinner2s_shapes(name, shape):
    dev = _card()
    _bn_check(*_bn_case(dev, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,kwargs", [
    ("mel_bn, per-mel-row f32", (B8, 1, 160, 513),
     dict(feature_dim=2, dtype=torch.float32, channels_last=False,
          scale=False, bias=False)),
    ("NCHW-contiguous f32", (B8, 32, 40, 50),
     dict(dtype=torch.float32, channels_last=False)),
    ("NCHW-contiguous bf16", (3, 24, 7, 9), dict(channels_last=False)),
    ("bns.5 / bns.6 (head) NCHW, as badwinner2 runs it", (B8, 1024, 1, 46),
     dict(channels_last=False)),
    ("rows no block divides, C=24", (7, 24, 13, 17), {}),
    ("C=20: one channel a thread", (5, 20, 11, 13), {}),
    ("f32 channels-last C=1024", (3, 1024, 1, 37),
     dict(dtype=torch.float32)),
    ("C=3000: chunks of 256 groups", (2, 3000, 3, 5), {}),
    ("scale off, bias on", (4, 64, 9, 11), dict(scale=False)),
    ("scale on, bias off", (4, 64, 9, 11), dict(bias=False)),
])
def test_batch_norm_kernels_in_each_layout(name, shape, kwargs):
    dev = _card()
    _bn_check(*_bn_case(dev, shape, **kwargs))


@pytest.mark.gpu
def test_batch_norm_kernels_on_a_constant_channel():
    """A constant channel: its variance is 0 or rounds below it (the clamp
    active), its output the bias up to the mean's rounding times rstd."""
    dev = _card()
    m, x, dy = _bn_case(dev, (B8, 64, 20, 30), constant=5)
    y = _bn_check(m, x, dy)[0]
    off = (y[:, 5].float() - m.bias[5]).abs().max()
    assert off <= 1e-3, off


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,kwargs", [
    ("bns.0", (B8, 64, 158, 511), {}),
    ("mel_bn", (B8, 1, 160, 513),
     dict(feature_dim=2, dtype=torch.float32, channels_last=False,
          scale=False, bias=False)),
])
def test_batch_norm_kernels_are_bitwise_repeatable(name, shape, kwargs):
    dev = _card()
    m, x, dy = _bn_case(dev, shape, **kwargs)
    first, second = _bn_run(m, x, dy), _bn_run(m, x, dy)
    for a, b in zip((*first[:2], *first[2], *first[3:]),
                    (*second[:2], *second[2], *second[3:])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_badwinner2_step_launches_each_batch_norm_kernel_8_times():
    """The 7 conv BatchNorms and mel_bn: each kernel once a BatchNorm in
    a training step (no mesh: one statistics finalize each)."""
    from audio_training_tpu_torch.ops.cuda import batch_norm as bn
    from audio_training_tpu_torch.train import fresh_metrics, make_train_step

    dev = _card()
    state, pre, batch = _train_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    mel, yy = pre(*batch, gen)
    step = make_train_step()
    bn.reset_launch_counts()
    state, _ = step(state, fresh_metrics(dev), mel, yy, gen)
    torch.cuda.synchronize()
    assert bn.launch_counts() == dict.fromkeys(bn.COUNTERS, 8)


BN_MESH_CASES = [
    ("bns.2", (B8, 128, 50, 167), {}),
    ("bns.4 (condense)", (B8, 128, 5, 163), {}),
    ("bns.5 / bns.6 (head) NCHW, as badwinner2 runs it", (B8, 1024, 1, 46),
     dict(channels_last=False)),
    ("mel_bn, per-mel-row f32", (B8, 1, 160, 513),
     dict(feature_dim=2, dtype=torch.float32, channels_last=False,
          scale=False, bias=False)),
    ("NCHW-contiguous f32", (B8, 32, 40, 50),
     dict(dtype=torch.float32, channels_last=False)),
    ("rows no block divides, C=24", (6, 24, 13, 17), {}),
    ("scale off, bias on", (4, 64, 9, 11), dict(scale=False)),
]


@pytest.fixture(scope="module")
def bn_mesh():
    """BN_MESH_CASES' modules and inputs on the card, and each rank's
    results under a mesh of two ranks on the card (one group for all)."""
    import torch_dp_ranks as ranks

    from audio_training_tpu_torch.parallel.multihost import run_ranks

    dev = _card()
    cases = [_bn_case(dev, shape, **kw) for _, shape, kw in BN_MESH_CASES]
    payload = [({k: t.cpu() for k, t in m.state_dict().items()},
                m.feature_dim, m.weight is not None, m.bias is not None,
                x.cpu(), dy.cpu()) for m, x, dy in cases]
    return cases, run_ranks(ranks.batch_norm_kernels_rank, 2,
                            args=(payload,), timeout_s=300.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(BN_MESH_CASES)),
                         ids=[name for name, _, _ in BN_MESH_CASES])
def test_batch_norm_kernels_under_a_two_rank_mesh(bn_mesh, case):
    """The mesh's all-reduces, forward of [sum x, sum x^2, rows] and
    backward of [sum dy, sum dy (x - mean)], make each rank's rows come
    out as the one-process batch's."""
    (m, x, dy), results = bn_mesh[0][case], bn_mesh[1]
    want = _bn_run(m, x, dy)
    y = torch.cat([r[case]["y"] for r in results]).to(x.device)
    dx = torch.cat([r[case]["dx"] for r in results]).to(x.device)
    assert _bn_close(y, want[0], BN_F32_REL)
    assert _bn_close(dx, want[1], BN_F32_REL)
    grads = [sum(gs).to(x.device)
             for gs in zip(*(r[case]["grads"] for r in results))]
    assert len(grads) == len(want[2])
    for g, w in zip(grads, want[2]):
        assert _bn_close(g, w, BN_GRAD_REL)
    launches = {"statistics": 1, "statistics_finalize": 2, "apply": 1,
                "backward_reduce": 1, "backward_finalize": 1,
                "backward_apply": 1}
    for r in results:
        for g, w in zip(r[case]["stats"], want[3:]):
            assert _bn_close(g.to(x.device), w, BN_F32_REL)
        assert r[case]["counts"] == launches


@pytest.mark.gpu
def test_batch_norm_kernels_refuse_what_they_do_not_take():
    from audio_training_tpu_torch.models.layers import KerasBatchNorm

    dev = _card()
    m = KerasBatchNorm(8).to(dev).train()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        m(torch.zeros(2, 8, 3, 3, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        m.double()(torch.zeros(2, 8, 3, 3, device=dev, dtype=torch.float64))
    m = KerasBatchNorm(8).to(dev).train()
    with pytest.raises(ValueError, match="dense"):
        m(torch.zeros(2, 8, 3, 6, device=dev)[..., ::2])
    with pytest.raises(ValueError, match="dense"):
        m(torch.zeros(1, 8, 3, 3, device=dev).expand(4, 8, 3, 3))


# ---- the eval conv epilogue -------------------------------------------------

EPILOGUE_CASES = [
    # (name, conv output shape, channels-last, activation, slope, first)
    ("badwinner2 bns.0: LeakyReLU first", (2, 64, 158, 61), True,
     "leaky_relu", 0.01, True),
    ("badwinner2 bns.5: C in the middle", (8, 1024, 1, 46), False,
     "leaky_relu", 0.01, True),
    ("B3 expand: SiLU after", (2, 160, 40, 129), True, "silu", 0.0, False),
    ("B3 depthwise, C=1392", (2, 1392, 5, 17), True, "silu", 0.0, False),
    ("B3 project, C=136", (2, 136, 10, 33), True, None, 0.0, False),
    ("B3 head, C=1536", (2, 1536, 5, 17), True, "silu", 0.0, False),
    ("C=40 in the middle", (3, 40, 7, 9), False, "silu", 0.0, False),
    ("C=7: one channel a thread", (3, 7, 11, 13), True, "leaky_relu", 0.3,
     False),
    ("C=20 SiLU first", (3, 20, 5, 6), True, "silu", 0.0, True),
    ("C=4100: a grid past the cap", (2, 4100, 2, 3), True, "silu", 0.0,
     False),
]


def _epilogue_case(dev, shape, channels_last, dtype, residual, seed=0):
    """A conv output, its bias, running statistics, scale and offset, and
    a residual (or None) on the card."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn(shape, generator=g) * 2).to(dev, dtype).contiguous(
        memory_format=fmt)
    params = [torch.randn(c, generator=g) * 0.5,  # conv bias
              torch.randn(c, generator=g),  # running mean
              torch.rand(c, generator=g) * 2 + 0.1,  # running variance
              torch.rand(c, generator=g) + 0.5,  # scale
              torch.randn(c, generator=g) * 0.3]  # offset
    r = (torch.randn(shape, generator=g).to(dev, dtype).contiguous(
        memory_format=fmt) if residual else None)
    return x, [p.to(dev) for p in params], r


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("name,shape,channels_last,act,slope,first",
                         EPILOGUE_CASES, ids=[c[0] for c in EPILOGUE_CASES])
def test_conv_epilogue_kernel_matches_plain(name, shape, channels_last, act,
                                            slope, first, residual, dtype):
    """The kernel and its plain version differ in f32 rounding order and
    SiLU's exponential alone: bf16 within one step of the max and at most
    1% of the values off, f32 within 1e-5 of the max; the output in the
    input's layout."""
    from audio_training_tpu_torch.ops.cuda import conv_epilogue as ce

    dev = _card()
    x, params, r = _epilogue_case(dev, shape, channels_last, dtype, residual)
    counts, got = _epilogue_counts(
        lambda: ce.eval_epilogue(x, *params, 1e-3, act, slope, first, r))
    want = ce.eval_epilogue_plain(x, *params, 1e-3, act, slope, first, r)
    assert counts == {"rows": int(channels_last),
                      "mid": int(not channels_last), "plain": 0}
    assert got.dtype == dtype and got.stride() == x.stride()
    assert _bn_close(got, want, BN_F32_REL)


@pytest.mark.gpu
def test_conv_epilogue_kernel_off_the_grid_and_with_a_residual_laid_out_otherwise():
    """A conv output off the 16-byte grid (one element a thread) and a
    NCHW residual of a channels-last output (copied into its layout)."""
    from audio_training_tpu_torch.ops.cuda import conv_epilogue as ce

    dev = _card()
    x, params, r = _epilogue_case(dev, (2, 48, 9, 11), True, torch.bfloat16,
                                  True)
    flat = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
    off = flat[1:].view(2, 9, 11, 48).permute(0, 3, 1, 2)
    off.copy_(x)
    for y, res in ((off, r), (x, r.contiguous())):
        got = ce.eval_epilogue(y, *params, 1e-3, "silu", 0.0, False, res)
        want = ce.eval_epilogue_plain(y, *params, 1e-3, "silu", 0.0, False,
                                      res)
        assert _bn_close(got, want, BN_F32_REL)


@pytest.mark.gpu
def test_conv_epilogue_kernel_refuses_what_it_does_not_take():
    from audio_training_tpu_torch.ops.cuda import conv_epilogue as ce

    from audio_training_tpu_torch.utils import profiling

    dev = _card()
    x, params, r = _epilogue_case(dev, (2, 8, 3, 3), True, torch.bfloat16,
                                  True)
    profiling.reset_counts("conv_epilogue")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ce.eval_epilogue(x.half(), *params, 1e-3)
    with pytest.raises(ValueError, match="dense"):
        ce.eval_epilogue(x[..., ::2], *params, 1e-3)
    with pytest.raises(ValueError, match="float32 running_mean"):
        ce.eval_epilogue(x, params[0], params[1].double(), *params[2:], 1e-3)
    with pytest.raises(ValueError, match="residual"):
        ce.eval_epilogue(x, *params, 1e-3, residual=r.float())
    with pytest.raises(ValueError, match="activation"):
        ce.eval_epilogue(x, *params, 1e-3, "relu")
    assert profiling.counts("conv_epilogue") == {"rows": 0, "mid": 0,
                                                 "plain": 0}


def _epilogue_counts(run):
    from audio_training_tpu_torch.utils import profiling

    profiling.reset_counts("conv_epilogue")
    out = run()
    torch.cuda.synchronize()
    return profiling.counts("conv_epilogue"), out


def _epilogue_model(name, dev, dtype=None):
    from audio_training_tpu_torch.models.backbones import EfficientNetV2
    from audio_training_tpu_torch.models.badwinner2 import BadWinner2

    g = torch.Generator().manual_seed(0)
    if name == "badwinner2":
        return BadWinner2(7, logits_only=True, dtype=dtype, generator=g,
                          dropout=0.0).to(dev).eval()
    return EfficientNetV2(3, "b3", dtype=dtype, generator=g).to(dev).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,calls", [
    ("badwinner2", (2, 160, 120, 1), 7),  # NHWC mel
    ("efficientnetv2b3", (2, 3, 64, 64), 87),  # NCHW image
])
def test_eval_forward_on_the_card_runs_the_epilogue_kernel(name, shape,
                                                           calls):
    """Under no_grad every block's epilogue is the kernel (bf16 and f32);
    with a gradient recorded none is, and in f32 the two agree: logits
    within 1e-4 of the max."""
    dev = _card()
    # a mel's magnitudes, an image's [0, 1)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    model = _epilogue_model(name, dev, torch.bfloat16)
    with torch.no_grad():
        counts, _ = _epilogue_counts(lambda: model(x))
    assert counts["rows"] + counts["mid"] == calls and counts["plain"] == 0
    model = _epilogue_model(name, dev)
    with torch.no_grad():
        counts, fused = _epilogue_counts(lambda: model(x))
    assert counts["rows"] + counts["mid"] == calls and counts["plain"] == 0
    counts, plain = _epilogue_counts(lambda: model(x))
    assert counts == {"rows": 0, "mid": 0, "plain": calls}
    assert _rel(fused.float(), plain.detach().float()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["a block", "badwinner2"])
def test_fp16_eval_forward_raises(name):
    """The kernel takes bf16 and f32 alone, and an eval forward on the
    card hands it every block: an fp16 one raises rather than falling
    back to the unfused passes."""
    from audio_training_tpu_torch.models import layers
    from audio_training_tpu_torch.models.badwinner2 import BadWinner2

    dev = _card()
    g = torch.Generator().manual_seed(0)
    if name == "a block":
        conv = layers.Conv(8, 16, (3, 3), padding="SAME", generator=g,
                           dtype=torch.float16).to(dev)
        bn = layers.KerasBatchNorm(16).to(dev).eval()
        x = torch.rand(2, 8, 5, 7, generator=g).to(dev)

        def run():
            return layers.conv_bn(conv, bn, x, "silu")
    else:
        model = BadWinner2(7, logits_only=True, dtype=torch.float16,
                           generator=g, dropout=0.0).to(dev).eval()
        x = torch.rand(2, 160, 120, 1, generator=g).to(dev)

        def run():
            return model(x)
    with torch.no_grad(), pytest.raises(ValueError, match="float16"):
        run()


@pytest.mark.gpu
def test_train_step_runs_no_epilogue_kernel():
    from audio_training_tpu_torch.train import fresh_metrics, make_train_step

    dev = _card()
    state, pre, batch = _train_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    mel, yy = pre(*batch, gen)
    step = make_train_step()
    counts, _ = _epilogue_counts(
        lambda: step(state, fresh_metrics(dev), mel, yy, gen))
    assert counts == {"rows": 0, "mid": 0, "plain": 7}
