"""Configuration, copied from ``audio_training_tpu/config.py``.

The port keeps its own copy so that it never imports the JAX package.
Every config of the JAX module is here, and the JSON forms are the same:
a JAX ``-c`` file or a ``metadata.txt`` ``featurizer`` entry loads
unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
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
class SplitConfig:
    """Train/val/test split parameters (build.py:47-48)."""

    validation_percent: float = 0.15
    test_percent: float = 0.05
    min_samples: int = 1
    seed: int = 42


@dataclass(frozen=True)
class SamplingConfig:
    """Per-track sample extraction parameters (audiodataset.py:39,107-119)."""

    max_track_samples: int = 4
    tighten_tracks: bool = False
    filter_rms: bool = True
    rms_filter_threshold: float = 0.1
    use_segments: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training-harness parameters (audiomodel.py:117-153, 2238-2414)."""

    model_name: str = "badwinner2"
    batch_size: int = 32
    learning_rate: float = 0.01
    epochs: int = 100
    early_stop_patience: int = 10
    reduce_lr_patience: int = 5
    reduce_lr_factor: float = 0.5
    multi_label: bool = True
    use_generic_bird: bool = True
    loss: str = "bce"  # bce | cce | weighted_bce | soft_f1 | focal
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.5  # get_dataset passes alpha=0.5 (tfdataset.py:477)
    mixup_chance: float = 0.25
    use_weighting: bool = False
    weight_min: float = 0.25  # class-weight clamp (tfdataset.py:1755-1758)
    weight_max: float = 4.0
    # --no-low-samples: exclude oversampled low-count samples
    # (tfdataset.py:728-733)
    no_low_samples: bool = False
    # keep samples tagged ONLY generic "bird"; off = the reference's default
    # others_filter drops them from multi-label training
    # (tfdataset.py:735-755, audiomodel --use_bird_tags)
    use_bird_tags: bool = False
    # train on band-passed sample variants when records carry them
    # (tfdataset.py:1066-1078; build with --add-buttered to produce them)
    filter_freq: bool = False
    random_butter: float = 0.0  # reference trains with 0.6 when set
    dropout: float = 0.5
    seed: int = 0
    # per-epoch validation confusion artifact (npy+png), the reference's
    # TensorBoard confusion image (audiomodel.py:1262-1314)
    epoch_confusion: bool = False
    # the JAX package's mesh and dtype fields, kept so that its JSON files
    # load unchanged: compute_dtype picks the model's dtype; num_data_shards
    # > 1 is refused by train_run until data parallelism is ported;
    # param_dtype, data_axis and model_axis name mesh parts with no
    # one-card meaning and are not read
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    data_axis: str = "data"
    model_axis: str = "model"
    num_data_shards: int = 1
    remat: bool = False
    # host loader processes for train-split decode; None = the
    # AUDIO_TPU_LOADER_WORKERS environment variable, else 0 (one thread)
    loader_workers: int | None = None
    # exact one-pass BatchNorm running-stat re-estimation after fit
    # (train/step.reestimate_batch_stats): short schedules leave the
    # momentum-0.99 EMA stale and eval-mode quality collapses while
    # train-mode metrics look fine.  Beyond-parity robustness feature.
    bn_reestimate: bool = False


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


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def config_to_dict(cfg: Any) -> dict:
    return _to_jsonable(cfg)


def save_config(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(json.dumps(config_to_dict(cfg), indent=2))


def load_config(cls: type, path: str | Path) -> Any:
    return config_from_dict(cls, json.loads(Path(path).read_text()))
