"""Host-side corpus tooling (a port of ``audio_training_tpu/corpus``): audio
decode and write, the sidecar corpus model and its sampling, the split and
balancing, and the GZIP TFRecord writer behind ``cli/build``."""

from audio_training_tpu_torch.corpus.audioio import (
    load_recording,
    load_wav,
    resample,
    save_wav,
)
from audio_training_tpu_torch.corpus.dataset import (
    AudioDataset,
    AudioSample,
    Recording,
    Track,
    best_rms,
    ensure_track_length,
    filter_track,
    load_metadata,
    remove_rms_noise,
    space_signals,
)
from audio_training_tpu_torch.corpus.split import (
    oversample_ds,
    split_by_file,
    split_label,
    split_randomly,
    undersample_ds,
    validate_datasets,
    write_training_meta,
)
from audio_training_tpu_torch.corpus.writer import (
    create_tf_records,
    load_data,
    process_recording,
)

__all__ = [
    "AudioDataset",
    "Recording",
    "Track",
    "AudioSample",
    "load_metadata",
    "filter_track",
    "space_signals",
    "ensure_track_length",
    "best_rms",
    "remove_rms_noise",
    "split_label",
    "split_randomly",
    "split_by_file",
    "oversample_ds",
    "undersample_ds",
    "validate_datasets",
    "write_training_meta",
    "create_tf_records",
    "process_recording",
    "load_data",
    "load_recording",
    "load_wav",
    "resample",
    "save_wav",
]
