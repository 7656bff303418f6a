"""Featurization ops: waveform -> mel image and the normalizers (port of
``audio_training_tpu/ops/features.py:26-198``, the reference's per-batch
``tf.data`` maps, ``tfdataset.py:1818-2059``), with dual-badwinner2's two
band-limited views on K2 (``csrc/melspec.cu``); the mixup and SpecAugment
augmentations (``:201-302``), and the host-side band-pass filter of the
long-recording windows (``:305-341``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda.melspec import fused_power_mel_complex
from audio_training_tpu_torch.ops.mel import mel_filterbank
from audio_training_tpu_torch.ops.stft import stft_centered, stft_tf_style
from audio_training_tpu_torch.parallel.collectives import global_extrema
from audio_training_tpu_torch.parallel.mesh import active_mesh, local_rows
from audio_training_tpu_torch.utils.profiling import span


def mag_transform(x: torch.Tensor, a: torch.Tensor | float) -> torch.Tensor:
    """Trainable magnitude compression ``x**sigmoid(a)``
    (badwinner2.MagTransform, badwinner2.py:47-49); ``a`` is taken in
    ``x``'s dtype, as the JAX version does."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return x ** torch.sigmoid(a)


def power_to_db(mel: torch.Tensor) -> torch.Tensor:
    """librosa.power_to_db equivalent (tfdataset.py:1906-1913): dB relative
    to the global max, floored at max-80."""
    amin = 1e-10
    out = 10.0 * torch.log10(mel.clamp_min(amin))
    out = out - 10.0 * torch.log10(mel.max().clamp_min(amin))
    return torch.maximum(out, out.max() - 80.0)


def normalize_minmax(data: torch.Tensor) -> torch.Tensor:
    """Global min-max to [-1, 1] (tfdataset.py:1897-1902).  Under an
    entered data-parallel mesh the minimum and maximum are the global
    batch's (``parallel.collectives.global_extrema``), as in JAX's SPMD."""
    mesh = active_mesh()
    if mesh is not None:
        min_v, max_v = global_extrema(mesh, data)
        return 2.0 * ((data - min_v) / (max_v - min_v)) - 1.0
    max_v = data.max()
    min_v = data.min()
    return 2.0 * ((data - min_v) / (max_v - min_v)) - 1.0


def normalize_std(data: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Global standardization (tfdataset.py:1883-1893), the population
    standard deviation as ``jnp.std`` takes it."""
    return (data - data.mean()) / (data.std(correction=0) + eps)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-last-axis min-max used after mixup (tfdataset.normalize,
    tfdataset.py:1916-1934): subtract row min, divide by row max (of the
    shifted data), add 1e-6, then map to [-1, 1]."""
    with span("normalize"):
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


def mel_from_waveform_centered(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    n_fft: int,
    hop: int,
    power: int = 1,
) -> torch.Tensor:
    """Inference-featurizer convention (predict_utils.get_spect,
    predict_utils.py:163-239): librosa centered STFT, magnitude ``|stft|``
    (power=1 by default there), then the mel projection.
    Output: ``(B, n_mels, frames)``."""
    spec = stft_centered(raw, n_fft, hop)  # (B, F, T)
    mag = torch.sqrt(spec.real**2 + spec.imag**2)
    if power != 1:
        mag = mag**power
    return torch.einsum("mf,bft->bmt", mel_weights.to(mag.dtype), mag)


def band_masked_bank(mel_weights, n_fft: int, sr: int, lo: float,
                     hi: float) -> np.ndarray:
    """The ``(n_mels, n_fft//2+1)`` bank with the bins outside ``[lo, hi]``
    zeroed, transposed to the ``(F, M)`` float32 layout K2 takes:
    ``W' = diag(mask) W``, so ``sum_f mask_f p_f W[f, m] = sum_f p_f
    W'[f, m]`` with the same products.  The bin frequencies and the
    comparison are float32, as the JAX function computes them."""
    w = np.asarray(mel_weights, np.float32)
    freqs = np.arange(n_fft // 2 + 1, dtype=np.float32) * np.float32(
        sr / n_fft)
    mask = (freqs >= np.float32(lo)) & (freqs <= np.float32(hi))
    return np.ascontiguousarray((w * mask[None, :].astype(np.float32)).T)


class DualMel:
    """dual-badwinner2's two band-limited mel views (tfdataset.raw_to_mel_dual,
    tfdataset.py:1818-1866; JAX ``ops/features.py:141-178``): view A a
    0-3 kHz mel at 2048/278, view B a 500 Hz-15 kHz mel at 1024/280 by
    default.

    The band limit is JAX's frequency-domain brick wall (the reference's
    host-side butterworth cannot run on the device), folded into the bank:
    each view is :func:`stft_tf_style` then K2
    (``ops/cuda/melspec.fused_power_mel_complex``) on the band-masked,
    transposed bank, built here once so that K2's band-walk plan is built
    once per bank.  On CPU tensors K2's wrapper computes its plain version;
    on the card it launches the kernel or raises.  ``__call__(raw (B, n))``
    returns ``((B, M_a, T_a, 1), (B, M_b, T_b, 1))`` f32."""

    def __init__(self, mel_weights_a, mel_weights_b, sr: int = 48000,
                 params_a: tuple[int, int] = (2048, 278),
                 params_b: tuple[int, int] = (1024, 280),
                 band_a: tuple[float, float] = (0.0, 3000.0),
                 band_b: tuple[float, float] = (500.0, 15000.0),
                 device: str | torch.device = "cuda"):
        self.views = [
            (torch.as_tensor(band_masked_bank(w, n_fft, sr, lo, hi),
                             device=device), n_fft, hop)
            for w, (n_fft, hop), (lo, hi) in ((mel_weights_a, params_a,
                                               band_a),
                                              (mel_weights_b, params_b,
                                               band_b))]

    def __call__(self, raw: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        out = []
        for bank_t, n_fft, hop in self.views:
            spec = stft_tf_style(raw, n_fft, hop)  # (B, T, F) complex64
            mel = fused_power_mel_complex(spec, bank_t)  # (B, T, M)
            out.append(mel.transpose(1, 2)[..., None])
        return out[0], out[1]


def raw_to_mel_dual(
    raw: torch.Tensor,
    mel_weights_a,
    mel_weights_b,
    sr: int = 48000,
    params_a: tuple[int, int] = (2048, 278),
    params_b: tuple[int, int] = (1024, 280),
    band_a: tuple[float, float] = (0.0, 3000.0),
    band_b: tuple[float, float] = (500.0, 15000.0),
) -> tuple[torch.Tensor, torch.Tensor]:
    """:class:`DualMel`'s two views of ``raw`` in one call, the JAX
    function's signature; it builds the masked banks on each call, so a
    caller that featurizes many batches keeps a :class:`DualMel`."""
    return DualMel(mel_weights_a, mel_weights_b, sr, params_a, params_b,
                   band_a, band_b, device=raw.device)(raw)


def raw_to_mel_multi(
    raw: torch.Tensor,
    weight_sets: list[torch.Tensor],
    stft_params: list[tuple[int, int]],
) -> torch.Tensor:
    """Multi-scale RGB mel (tfdataset.raw_to_mel_rgb, tfdataset.py:1938-2004):
    one channel per (mel_weights, (n_fft, hop)) pair, concatenated on the
    channel axis."""
    return torch.cat([raw_to_mel(raw, w, n_fft=n_fft, hop=hop, channels=1)
                      for w, (n_fft, hop) in zip(weight_sets, stft_params)],
                     dim=-1)


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
    (zero = take sample two unchanged, tfdataset.py:934-940).  Under an
    entered data-parallel mesh ``batch`` is this rank's rows: the weights
    are drawn for the global batch and this rank's rows taken, so that
    with the same generator state on every rank they are the
    single-device draw's."""
    batch, rows = local_rows(batch)
    l = sample_beta(gen, batch, alpha)
    aug = (torch.rand(batch, generator=gen, device=gen.device)
           < chance).to(l.dtype)
    return (l * aug)[rows]


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
# SpecAugment (ops/features.py:267-302 of the JAX package), split into the
# draw, from an explicit generator, and the apply of given starts and widths
# ---------------------------------------------------------------------------


class SpecAugmentDraw(NamedTuple):
    """Each sample's mask starts and widths, ``(B, count)`` int64 each."""

    time_starts: torch.Tensor
    time_widths: torch.Tensor
    freq_starts: torch.Tensor
    freq_widths: torch.Tensor


def sample_spec_augment(gen: torch.Generator, batch: int, n_mels: int,
                        frames: int, num_time_masks: int = 2,
                        time_mask_width: int = 50, num_freq_masks: int = 2,
                        freq_mask_width: int = 20) -> SpecAugmentDraw:
    """JAX's draw with its limits: a start uniform in ``[0, max(size -
    width, 1))`` and a width uniform in ``[0, width]`` for each mask.  As
    :func:`sample_mix_weights`, drawn for the global batch under an
    entered data-parallel mesh, this rank's rows returned."""
    batch, rows = local_rows(batch)

    def draw(size, width, count):
        starts = torch.randint(0, max(size - width, 1), (batch, count),
                               generator=gen, device=gen.device)
        widths = torch.randint(0, width + 1, (batch, count), generator=gen,
                               device=gen.device)
        return starts, widths

    return SpecAugmentDraw(*(d[rows] for d in (
        *draw(frames, time_mask_width, num_time_masks),
        *draw(n_mels, freq_mask_width, num_freq_masks))))


def apply_spec_augment(mel: torch.Tensor, draw: SpecAugmentDraw,
                       mask_value: float = 0.0) -> torch.Tensor:
    """Sets ``mel[b, m, t, ...]`` to ``mask_value`` where frame ``t`` lies
    in one of sample ``b``'s time masks or mel ``m`` in one of its
    frequency masks: ``[start, start + width)``."""
    b, n_mels, frames = mel.shape[:3]

    def mask(size, starts, widths):
        pos = torch.arange(size, device=mel.device)
        starts = starts.to(mel.device)[..., None]
        widths = widths.to(mel.device)[..., None]
        return ((pos >= starts) & (pos < starts + widths)).any(1)  # (B, size)

    tmask = mask(frames, draw.time_starts, draw.time_widths)
    fmask = mask(n_mels, draw.freq_starts, draw.freq_widths)
    full = tmask[:, None, :] | fmask[:, :, None]  # (B, n_mels, T)
    full = full.reshape(full.shape + (1,) * (mel.ndim - 3))
    return torch.where(full, torch.as_tensor(mask_value, dtype=mel.dtype,
                                             device=mel.device), mel)


def spec_augment(gen: torch.Generator, mel: torch.Tensor,
                 num_time_masks: int = 2, time_mask_width: int = 50,
                 num_freq_masks: int = 2, freq_mask_width: int = 20,
                 mask_value: float = 0.0) -> torch.Tensor:
    """SpecAugment-style time / frequency masking over ``(B, n_mels, T,
    ...)``, a TPU-native extra of the JAX package (the reference has
    none): :func:`sample_spec_augment` then :func:`apply_spec_augment`."""
    b, n_mels, frames = mel.shape[:3]
    draw = sample_spec_augment(gen, b, n_mels, frames, num_time_masks,
                               time_mask_width, num_freq_masks,
                               freq_mask_width)
    return apply_spec_augment(mel, draw, mask_value)


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
