"""Track detection on the host (numpy/scipy)."""

from audio_training_tpu_torch.detect.signals import (
    Signal,
    get_end,
    get_tracks_from_signals,
    merge_signals,
    signal_noise,
)

__all__ = [
    "Signal",
    "signal_noise",
    "merge_signals",
    "get_tracks_from_signals",
    "get_end",
]
