"""Configuration, copied from ``audio_training_tpu/config.py``.

The port keeps its own copy so that it never imports the JAX package.
Ported so far: the constants, ``FeaturizerConfig``, ``InferenceConfig`` and
``config_from_dict``; the split, sampling and train configs follow with the
slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

# Invariant constants of the reference stack (tfdataset.py:42-57,
# audiodataset.py:107-119).  These are *defaults*; every one is overridable
# through FeaturizerConfig.
SR = 48000
SEGMENT_LENGTH = 3.0  # seconds
SEGMENT_STRIDE = 1.0  # seconds
NFFT = 4096
HOP_LENGTH = 281
N_MELS = 160
BREAK_FREQ = 1000.0
FMIN = 100.0
FMAX = 11000.0
POWER = 2
SAMPLES_PER_CLIP = int(SR * SEGMENT_LENGTH)  # 144 000
STFT_BINS = NFFT // 2 + 1  # 2049
# tf.signal.stft(pad_end=True) frame count: ceil(144000 / 281) = 513
MEL_FRAMES = -(-SAMPLES_PER_CLIP // HOP_LENGTH)


@dataclass(frozen=True)
class FeaturizerConfig:
    """Waveform -> mel-spectrogram featurization parameters
    (the reference's model ``metadata.txt``, audiomodel.py:597-658)."""

    sr: int = SR
    segment_length: float = SEGMENT_LENGTH
    segment_stride: float = SEGMENT_STRIDE
    n_fft: int = NFFT
    hop_length: int = HOP_LENGTH
    n_mels: int = N_MELS
    break_freq: float = BREAK_FREQ
    fmin: float = FMIN
    fmax: float = FMAX
    power: int = POWER
    # "htk" means plain librosa htk mel (break 700); False means the custom
    # break-frequency filterbank (custommel.py:6-8).
    htk: bool = False
    channels: int = 1
    mean_sub: bool = False
    db_scale: bool = False
    mfcc: bool = False

    def __post_init__(self) -> None:
        # A mis-set geometry would otherwise train on half-empty images.
        if self.sr <= 0:
            raise ValueError(f"sr must be positive, got {self.sr}")
        if self.n_fft <= 0 or self.hop_length <= 0 or self.n_mels <= 0:
            raise ValueError(
                f"n_fft/hop_length/n_mels must be positive, got "
                f"{self.n_fft}/{self.hop_length}/{self.n_mels}"
            )
        if self.hop_length >= self.n_fft:
            raise ValueError(
                f"hop_length ({self.hop_length}) must be smaller than "
                f"n_fft ({self.n_fft}) — frames would skip samples"
            )
        if self.fmin < 0 or self.fmin >= self.fmax:
            raise ValueError(
                f"need 0 <= fmin < fmax, got fmin={self.fmin} "
                f"fmax={self.fmax}"
            )
        if self.fmax > self.sr / 2:
            raise ValueError(
                f"fmax ({self.fmax}) exceeds Nyquist ({self.sr / 2}) — "
                "the upper mel filters would be empty"
            )

    @property
    def samples_per_clip(self) -> int:
        return int(round(self.sr * self.segment_length))

    @property
    def stft_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def mel_frames(self) -> int:
        # tf.signal.stft pad_end=True convention (tfdataset.py:2026-2034)
        return -(-self.samples_per_clip // self.hop_length)

    @property
    def mel_shape(self) -> tuple[int, int]:
        return (self.n_mels, self.mel_frames)

    @property
    def input_shape(self) -> tuple[int, int, int]:
        # DIMENSIONS = (160, 513, 1) (tfdataset.py:175-180)
        return (self.n_mels, self.mel_frames, self.channels)


@dataclass(frozen=True)
class InferenceConfig:
    """Sliding-window inference parameters (predict.py:503, preeval.py)."""

    threshold: float = 0.7
    aggregation: str = "mean"  # mean | max | votes
    max_window_batch: int = 64
    bucket_sizes: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def config_from_dict(cls: type, data: dict) -> Any:
    """Build a config dataclass from a JSON dict, ignoring unknown keys
    (a run's ``metadata.txt`` ``featurizer`` entry).  JSON has no tuples:
    a list read back into a ``tuple[int, ...]`` field becomes a tuple
    again, as in the JAX package."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue
        if fields[k].type == "tuple[int, ...]" and isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)
