"""The port's DSP ops against the JAX package's, on the same numpy inputs.

Tolerances: the mel filterbank and window are numpy on both sides and must
be bit-exact; the f32 ops agree to rtol 1e-5, with an absolute floor of
1e-5 of the array's scale where values cross zero.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu import config as jax_config
from audio_training_tpu.ops import features as jf
from audio_training_tpu.ops import mel as jmel
from audio_training_tpu.ops import stft as jstft
from audio_training_tpu_torch import config as tconfig
from audio_training_tpu_torch.ops import features as tf_
from audio_training_tpu_torch.ops import mel as tmel
from audio_training_tpu_torch.ops import stft as tstft

# both ops packages export a function named ``pcen`` over the module
jpcen = importlib.import_module("audio_training_tpu.ops.pcen")
tpcen = importlib.import_module("audio_training_tpu_torch.ops.pcen")

torch.set_num_threads(2)

RTOL = 1e-5


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kw", [
    {},
    {"htk": True},
    {"n_mels": 96, "fmin": 50.0, "fmax": 8000.0},
    {"sr": 8000, "n_fft": 256, "hop_length": 100, "n_mels": 40, "fmax": 3800.0},
])
def test_mel_filterbank_bit_exact(kw):
    jcfg = jax_config.FeaturizerConfig(**kw)
    tcfg = tconfig.FeaturizerConfig(**kw)
    np.testing.assert_array_equal(
        tf_.build_mel_weights(tcfg), jf.build_mel_weights(jcfg)
    )
    np.testing.assert_array_equal(
        tmel.mel_filterbank(48000, 20, 0.0, 20000.0, 1024, 1750.0),
        jmel.mel_filterbank(48000, 20, 0.0, 20000.0, 1024, 1750.0),
    )


def test_config_copy_matches_jax():
    """Same defaults, derived geometry and constants as the JAX config."""
    jcfg, tcfg = jax_config.FeaturizerConfig(), tconfig.FeaturizerConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for prop in ("samples_per_clip", "stft_bins", "mel_frames", "mel_shape",
                 "input_shape"):
        assert getattr(jcfg, prop) == getattr(tcfg, prop)
    for const in ("SR", "NFFT", "HOP_LENGTH", "N_MELS", "SAMPLES_PER_CLIP",
                  "STFT_BINS", "MEL_FRAMES"):
        assert getattr(jax_config, const) == getattr(tconfig, const)


@pytest.mark.parametrize("name,kw", [
    ("InferenceConfig", {}),
    ("InferenceConfig", {"bucket_sizes": (3, 9), "aggregation": "max"}),
    ("FeaturizerConfig", {}),
    ("FeaturizerConfig", {"sr": 8000, "n_fft": 512, "hop_length": 100,
                          "n_mels": 96, "fmax": 3500.0, "htk": True}),
])
def test_config_json_round_trip_matches_jax(name, kw):
    """A config written to JSON and read back by ``config_from_dict`` holds
    the same fields with the same types in both packages: JSON's lists
    become tuples again."""
    jcls, tcls = getattr(jax_config, name), getattr(tconfig, name)
    text = json.dumps(dataclasses.asdict(tcls(**kw)))
    assert text == json.dumps(dataclasses.asdict(jcls(**kw)))
    got = tconfig.config_from_dict(tcls, json.loads(text))
    want = jax_config.config_from_dict(jcls, json.loads(text))
    assert got == tcls(**kw)
    for field in dataclasses.fields(tcls):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert a == b and type(a) is type(b), field.name


@pytest.mark.parametrize("bad", [
    {"sr": 0}, {"hop_length": 0}, {"hop_length": 4096}, {"fmin": 12000.0},
    {"fmax": 30000.0},
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jax_config.FeaturizerConfig(**bad)
    with pytest.raises(ValueError) as terr:
        tconfig.FeaturizerConfig(**bad)
    assert str(terr.value) == str(jerr.value)


def test_hann_window_and_frame_counts():
    np.testing.assert_array_equal(tstft.hann_window(4096),
                                  jstft.hann_window(4096))
    for n, hop in [(144000, 281), (24000, 281), (30000, 160), (4096, 313)]:
        assert tstft.num_frames_tf(n, hop) == jstft.num_frames_tf(n, hop)
        assert (tstft.num_frames_centered(n, hop)
                == jstft.num_frames_centered(n, hop))


@pytest.mark.parametrize("n,hop", [(144000, 281), (20000, 160), (5000, 313)])
def test_stft_tf_style_matches_jax(n, hop):
    """pad_end framing: ceil(n/hop) frames, the last ones reading zeros."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jstft.stft_tf_style(jnp.asarray(x), 4096, hop))
    got = tstft.stft_tf_style(torch.from_numpy(x), 4096, hop)
    assert got.shape[-2] == -(-n // hop)
    _close(torch.view_as_real(got), np.stack([want.real, want.imag], -1))


def test_raw_to_mel_matches_jax():
    cfg = tconfig.FeaturizerConfig()
    w = tf_.build_mel_weights(cfg)
    raw = np.random.default_rng(3).standard_normal(
        (2, cfg.samples_per_clip)).astype(np.float32)
    want = jf.raw_to_mel(jnp.asarray(raw), jnp.asarray(w), channels=3)
    got = tf_.raw_to_mel(torch.from_numpy(raw), torch.from_numpy(w),
                         channels=3)
    assert got.shape == (2, 160, 513, 3)
    _close(got, want)


def test_normalizers_and_mag_transform_match_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7000)) * 4 + 1).astype(np.float32)
    _close(tf_.normalize_rows(torch.from_numpy(x)), jf.normalize_rows(x))
    _close(tf_.normalize_minmax(torch.from_numpy(x)), jf.normalize_minmax(x))
    _close(tpcen.normalize_minmax_global(torch.from_numpy(x)),
           jpcen.normalize_minmax_global(x))
    p = rng.gamma(2.0, 30.0, (2, 16, 40)).astype(np.float32)
    for a in (-1.0, 0.3, np.float32(-1.7)):
        _close(tf_.mag_transform(torch.from_numpy(p), a),
               jf.mag_transform(jnp.asarray(p), a))


def test_ema_matches_jax_scan():
    rng = np.random.default_rng(7)
    x = rng.gamma(2.0, 10.0, (2, 30, 513)).astype(np.float32)
    init = x[:, :, 0]
    want = jpcen.ema_scan(jnp.asarray(x), 0.04, jnp.asarray(init), axis=2)
    got = tpcen.ema_scan(torch.from_numpy(x), 0.04, torch.from_numpy(init),
                         axis=2)
    _close(got, want)


@pytest.mark.parametrize("kw", [
    {}, {"gain": 0.9, "bias": 1.5, "root": 3.0, "smooth": 0.1},
    {"gain": 1.4, "root": 0.5},  # clamped to gain 1, root 1
])
@pytest.mark.parametrize("normalize", [True, False])
def test_pcen_matches_jax(kw, normalize):
    x = np.random.default_rng(11).gamma(2.0, 50.0, (2, 160, 513)).astype(
        np.float32)
    want = jpcen.pcen(jnp.asarray(x), time_axis=2, normalize=normalize, **kw)
    got = tpcen.pcen(torch.from_numpy(x), time_axis=2, normalize=normalize,
                     **kw)
    _close(got, want)
    if normalize:
        assert got.min() == -1.0 and got.max() == 1.0
