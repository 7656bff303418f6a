"""Read a run's ``metadata.txt`` (the reading half of
``audio_training_tpu/train/metadata.py``, field parity with
audiomodel.save_metadata, audiomodel.py:597-658)."""

from __future__ import annotations

import json
from pathlib import Path

from audio_training_tpu_torch.config import FeaturizerConfig, config_from_dict


def load_metadata(run_dir: str | Path) -> dict:
    return json.loads((Path(run_dir) / "metadata.txt").read_text())


def featurizer_from_metadata(meta: dict) -> FeaturizerConfig:
    """Reconstruct the featurizer from a saved metadata.txt (the inference
    path reads these fields, predict.py:743-816)."""
    if "featurizer" in meta:
        return config_from_dict(FeaturizerConfig, meta["featurizer"])
    return FeaturizerConfig(
        sr=int(meta.get("sample_rate", 48000)),
        n_fft=int(meta.get("n_fft", 4096)),
        hop_length=int(meta.get("hop_length", 281)),
        n_mels=int(meta.get("n_mels", 160)),
        break_freq=float(meta.get("break_freq", 1000)),
        fmin=float(meta.get("fmin", 100)),
        fmax=float(meta.get("fmax", 11000)),
        power=int(meta.get("power", 2)),
        htk=bool(meta.get("htk", False)),
        mean_sub=bool(meta.get("mean_sub", False)),
        db_scale=bool(meta.get("db_scale", False)),
    )
