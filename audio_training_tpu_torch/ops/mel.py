"""Mel filterbank with configurable break frequency (numpy).

A copy of ``audio_training_tpu/ops/mel.py:18-85``, kept here so the port
imports nothing of the JAX package.  Parity target: the reference
``custommel.py:6-61`` (librosa's filterbank with a generalized mel break
frequency).  Built once on the host; the featurizer moves it to the device.
:func:`band_tables` is the port's own: the band layout that the mel kernels
(``csrc/fused_featurizer.cu``, ``csrc/melspec.cu``) walk.
"""

from __future__ import annotations

import logging

import numpy as np

HTK_BREAK_FREQ = 700.0


def hz_to_mel(frequencies, break_freq: float):
    """Generalized HTK-style hz->mel (custommel.py:6-8)."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    return 2595.0 * np.log10(1.0 + frequencies / break_freq)


def mel_to_hz(mels, break_freq: float):
    mels = np.asarray(mels, dtype=np.float64)
    return break_freq * (10.0 ** (mels / 2595.0) - 1.0)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, break_freq: float):
    """Uniformly spaced mel-band center frequencies (custommel.py:11-15)."""
    min_mel = hz_to_mel(fmin, break_freq)
    max_mel = hz_to_mel(fmax, break_freq)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, break_freq)


def fft_frequencies(sr: float, n_fft: int):
    """Center frequency of each rFFT bin (librosa.fft_frequencies)."""
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def mel_filterbank(
    sr: float,
    n_mels: int,
    fmin: float,
    fmax: float,
    n_fft: int,
    break_freq: float = 1750.0,
) -> np.ndarray:
    """Triangular mel weights with Slaney normalization (custommel.py:18-54).

    Returns ``(n_mels, 1 + n_fft//2)`` float32.
    """
    n_mels = int(n_mels)
    weights = np.zeros((n_mels, int(1 + n_fft // 2)), dtype=np.float32)

    fftfreqs = fft_frequencies(sr=sr, n_fft=n_fft)
    centers = mel_frequencies(n_mels + 2, fmin, fmax, break_freq)

    fdiff = np.diff(centers)
    ramps = np.subtract.outer(centers, fftfreqs)

    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    # Slaney: approximately constant energy per channel
    enorm = 2.0 / (centers[2 : n_mels + 2] - centers[:n_mels])
    weights *= enorm[:, np.newaxis].astype(np.float32)

    if not np.all((centers[:-2] == 0) | (weights.max(axis=1) > 0)):
        logging.getLogger(__name__).warning(
            "Empty filters detected in mel frequency basis; some channels "
            "will produce empty responses (increase sr/fmax or reduce n_mels)."
        )
    return weights


# Backwards-compatible alias matching the reference public name
# (custommel.mel_f, custommel.py:18)
mel_f = mel_filterbank


def mel_spec(
    stft,
    sr: float,
    n_fft: int,
    hop_length: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    break_freq: float = 1750.0,
    power: int = 2,
) -> np.ndarray:
    """Host (numpy) mel spectrogram from a complex STFT (custommel.py:57-61).

    ``stft`` is ``(freq_bins, frames)`` complex; output ``(n_mels, frames)``.
    The on-device equivalent lives in :mod:`audio_training_tpu_torch.ops.features`.
    """
    magnitude = np.abs(stft) ** power
    mels = mel_filterbank(sr, n_mels, fmin, fmax, n_fft, break_freq)
    return mels.dot(magnitude)


def band_tables(mel_weights) -> tuple[np.ndarray, ...]:
    """Each filter's contiguous band ``[start, start + length)`` of bins,
    from its first to its last non-zero weight, for the kernels that walk
    the bands instead of the dense product: (start, length, offset into the
    flat weights, the flat weights), int32 and float32.  ``mel_weights`` is
    ``(n_mels, n_bins)``; an all-zero filter has length 0."""
    starts, lengths, flat = [], [], []
    for row in np.asarray(mel_weights, np.float32):
        nz = np.flatnonzero(row)
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        starts.append(lo)
        lengths.append(hi - lo)
        flat.append(row[lo:hi])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return (np.asarray(starts, np.int32), np.asarray(lengths, np.int32),
            offsets.astype(np.int32),
            np.concatenate(flat).astype(np.float32))
