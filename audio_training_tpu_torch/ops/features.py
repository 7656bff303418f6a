"""Featurization ops: waveform -> mel image and the normalizers (port of
``audio_training_tpu/ops/features.py:26-115``, the reference's per-batch
``tf.data`` maps, ``tfdataset.py:1883-2059``), the mixup augmentation
(``:201-264``), and the host-side band-pass filter of the long-recording
windows (``:305-341``)."""

from __future__ import annotations

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.mel import mel_filterbank
from audio_training_tpu_torch.ops.stft import stft_centered, stft_tf_style


def mag_transform(x: torch.Tensor, a: torch.Tensor | float) -> torch.Tensor:
    """Trainable magnitude compression ``x**sigmoid(a)``
    (badwinner2.MagTransform, badwinner2.py:47-49); ``a`` is taken in
    ``x``'s dtype, as the JAX version does."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return x ** torch.sigmoid(a)


def normalize_minmax(data: torch.Tensor) -> torch.Tensor:
    """Global min-max to [-1, 1] (tfdataset.py:1897-1902)."""
    max_v = data.max()
    min_v = data.min()
    return 2.0 * ((data - min_v) / (max_v - min_v)) - 1.0


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-last-axis min-max used after mixup (tfdataset.normalize,
    tfdataset.py:1916-1934): subtract row min, divide by row max (of the
    shifted data), add 1e-6, then map to [-1, 1]."""
    x = x - x.amin(dim=-1, keepdim=True)
    x = x / x.amax(dim=-1, keepdim=True) + 0.000001
    return (x - 0.5) * 2.0


def normalize_waveform(x: torch.Tensor) -> torch.Tensor:
    """Waveform min-max normalization used when building records
    (audiodataset.normalize_data, audiodataset.py:1334-1341)."""
    return normalize_rows(x)


def build_mel_weights(cfg: FeaturizerConfig) -> np.ndarray:
    """Host-side constant (n_mels, n_fft//2+1) mel matrix for a config."""
    break_freq = 700.0 if cfg.htk else cfg.break_freq
    return mel_filterbank(
        cfg.sr, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.n_fft, break_freq
    )


def mel_power(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    n_fft: int = 4096,
    hop: int = 281,
    power: int = 2,
    center: bool = False,
) -> torch.Tensor:
    """(B, samples) -> (B, n_mels, frames) f32 mel power, tf-stft framing,
    or with ``center`` the librosa centered framing of the Predictor.

    The reference squares the complex STFT and then takes the modulus
    (tfdataset.py:2044-2046); ``|z^2| == |z|^2``, so this computes the
    power spectrogram directly.
    """
    if center:
        spec = stft_centered(raw, n_fft, hop).transpose(-1, -2)  # (B, T, F)
    else:
        spec = stft_tf_style(raw, n_fft, hop)  # (B, T, F)
    p = spec.real**2 + spec.imag**2
    if power != 2:
        p = torch.sqrt(p) ** power
    return torch.einsum("mf,btf->bmt", mel_weights.to(p.dtype), p)


def raw_to_mel(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    n_fft: int = 4096,
    hop: int = 281,
    power: int = 2,
    channels: int = 3,
) -> torch.Tensor:
    """Batched waveform -> mel image, training-pipeline convention
    (tfdataset.raw_to_mel, tfdataset.py:2008-2059).
    Output: ``(B, n_mels, frames, channels)``."""
    image = mel_power(raw, mel_weights, n_fft, hop, power)[..., None]
    if channels > 1:
        image = image.repeat_interleave(channels, dim=-1)
    return image


# ---------------------------------------------------------------------------
# Mixup (ops/features.py:201-264 of the JAX package).  The samplers draw from
# an explicit torch.Generator on its own device: JAX keys and torch
# generators give different bits, so parity is held with injected weights
# and the samplers are tested by their distributions.
# ---------------------------------------------------------------------------


def sample_beta(gen: torch.Generator, size: int, alpha: float) -> torch.Tensor:
    """Beta(alpha, alpha) via a gamma ratio, the reference's construction
    (tfdataset.sample_beta_distribution, tfdataset.py:920-924).
    ``torch._standard_gamma`` is the one gamma sampler that takes a
    generator."""
    a = torch.full((size,), float(alpha), device=gen.device)
    g1 = torch._standard_gamma(a, generator=gen)
    g2 = torch._standard_gamma(a, generator=gen)
    return g1 / (g1 + g2)


def sample_mix_weights(gen: torch.Generator, batch: int, alpha: float = 0.5,
                       chance: float = 0.25) -> torch.Tensor:
    """Per-sample mixup weight: Beta(alpha, alpha) gated by ``chance``
    (zero = take sample two unchanged, tfdataset.py:934-940)."""
    l = sample_beta(gen, batch, alpha)
    aug = (torch.rand(batch, generator=gen, device=gen.device)
           < chance).to(l.dtype)
    return l * aug


def apply_mix(l: torch.Tensor, one: torch.Tensor,
              two: torch.Tensor) -> torch.Tensor:
    """``one * l + two * (1-l)`` with ``l`` broadcast over trailing axes."""
    x_l = l.to(one.device).reshape((one.shape[0],) + (1,) * (one.ndim - 1))
    return one * x_l + two * (1.0 - x_l)


def mix_labels(l: torch.Tensor, labels_one: torch.Tensor,
               labels_two: torch.Tensor,
               single_label: bool = True) -> torch.Tensor:
    """Label mix: hard max when ``single_label`` (tfdataset.py:948-951)."""
    y_l = l.to(labels_one.device).reshape(
        (labels_one.shape[0],) + (1,) * (labels_one.ndim - 1))
    if single_label:
        y_l = (y_l > 0.5).to(labels_one.dtype)
    return labels_one * y_l + labels_two * (1.0 - y_l)


def mix_up(gen: torch.Generator, images_one: torch.Tensor,
           labels_one: torch.Tensor, images_two: torch.Tensor,
           labels_two: torch.Tensor, alpha: float = 0.5, chance: float = 0.25,
           single_label: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch mixup (tfdataset.mix_up, tfdataset.py:930-955): each sample
    mixes with probability ``chance`` at a Beta(alpha, alpha) weight; an
    un-mixed sample is entirely ``images_two``, as in the reference."""
    l = sample_mix_weights(gen, images_one.shape[0], alpha, chance)
    return (apply_mix(l, images_one, images_two),
            mix_labels(l, labels_one, labels_two, single_label))


# ---------------------------------------------------------------------------
# Host-side DSP (scipy; ops/features.py:305-341 of the JAX package)
# ---------------------------------------------------------------------------


def butter_bandpass_sos(lowcut: float, highcut: float, fs: float, order: int = 2):
    """Design the band/low/high-pass used for per-track filtering
    (tfdataset.butter_bandpass / predict_utils, scipy host-side)."""
    from scipy.signal import butter

    nyq = 0.5 * fs
    low = lowcut / nyq
    high = highcut / nyq
    if low <= 0 and high <= 0:
        return None
    if high >= 1 or high <= 0:
        if low <= 0:
            return None
        return butter(order, low, btype="highpass", output="sos")
    if low <= 0:
        return butter(order, high, btype="lowpass", output="sos")
    if low >= high:
        # non-increasing critical frequencies would raise in scipy; the
        # reference's write side returns None for this malformed-metadata
        # case (audiodataset.py:1369-1372)
        return None
    return butter(order, [low, high], btype="bandpass", output="sos")


def butter_bandpass_filter(
    data: np.ndarray, lowcut: float, highcut: float, fs: float = 48000, order: int = 2
) -> np.ndarray:
    """Host IIR bandpass (tfdataset.butter_bandpass_filter,
    tfdataset.py:2068-2075)."""
    from scipy.signal import sosfilt

    if lowcut <= 0 and highcut <= 0:
        return data
    sos = butter_bandpass_sos(lowcut, highcut, fs, order)
    if sos is None:
        return data
    return np.float32(sosfilt(sos, data))
