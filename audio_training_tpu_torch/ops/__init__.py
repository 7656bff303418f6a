"""DSP ops: framing, STFT, mel, PCEN and the featurizer backends.  The
names below are those of the JAX package's ``ops.__all__``."""

from audio_training_tpu_torch.ops.mel import (
    hz_to_mel,
    mel_f,
    mel_filterbank,
    mel_frequencies,
    mel_spec,
)
from audio_training_tpu_torch.ops.stft import stft_centered, stft_tf_style
from audio_training_tpu_torch.ops.pcen import ema, ema_scan, ema_toeplitz, pcen
from audio_training_tpu_torch.ops.features import (
    build_mel_weights,
    mag_transform,
    mix_up,
    normalize_minmax,
    normalize_rows,
    normalize_std,
    normalize_waveform,
    power_to_db,
    raw_to_mel,
    spec_augment,
)

__all__ = [
    "hz_to_mel",
    "mel_f",
    "mel_filterbank",
    "mel_frequencies",
    "mel_spec",
    "stft_centered",
    "stft_tf_style",
    "ema",
    "ema_scan",
    "ema_toeplitz",
    "pcen",
    "build_mel_weights",
    "mag_transform",
    "mix_up",
    "normalize_minmax",
    "normalize_rows",
    "normalize_std",
    "normalize_waveform",
    "power_to_db",
    "raw_to_mel",
    "spec_augment",
]
