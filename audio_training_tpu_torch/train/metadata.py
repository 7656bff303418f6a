"""A run's ``metadata.txt`` (port of ``audio_training_tpu/train/metadata.py``,
field parity with audiomodel.save_metadata, audiomodel.py:597-658):
everything inference needs to reconstruct the featurizer and label space is
serialized beside the checkpoint.  ``save_metadata`` writes the JAX
package's fields, ``training_date`` aside, so either package's
``cli/predict`` reads the other's file."""

from __future__ import annotations

import json
import time
from pathlib import Path

from audio_training_tpu_torch.config import (
    FeaturizerConfig,
    config_from_dict,
    config_to_dict,
)
from audio_training_tpu_torch.taxonomy.ontology import Ontology

VERSION = 1


def save_metadata(
    run_dir: str | Path,
    model_name: str,
    labels: list[str],
    cfg: FeaturizerConfig,
    ontology: Ontology,
    loss_fn: str = "bce",
    multi_label: bool = True,
    use_generic_bird: bool = True,
    lme: bool = False,
    mean_sub: bool = False,
    history: dict | None = None,
    test_results: dict | None = None,
    training_data_meta: dict | None = None,
    extra: dict | None = None,
) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    stats: dict = {}
    if training_data_meta:
        stats.update(training_data_meta)
    stats.update(
        {
            "name": model_name,
            "magv2": True,
            "bird_thresh": 1,
            "use_generic_bird": use_generic_bird,
            "ebird_labels": list(labels),
            "labels": list(labels),
            "mean_sub": mean_sub,
            "loss_fn": loss_fn,
            "multi_label": multi_label,
            "bird_labels": list(ontology.bird_train_labels),
            "noise_labels": list(ontology.noise_labels),
            "extra_labels": list(ontology.extra_labels),
            "other_labels": list(ontology.other_labels),
            "fmin": cfg.fmin,
            "fmax": cfg.fmax,
            "n_mels": cfg.n_mels,
            "break_freq": cfg.break_freq,
            "power": cfg.power,
            "n_fft": cfg.n_fft,
            "hop_length": cfg.hop_length,
            "sample_rate": cfg.sr,
            "segment_length": cfg.segment_length,
            "segment_stride": cfg.segment_stride,
            "htk": cfg.htk,
            "channels": cfg.channels,
            "featurizer": config_to_dict(cfg),
            "lme": lme,
            "db_scale": cfg.db_scale,
            "training_date": str(time.time()),
            "version": VERSION,
        }
    )
    if history:
        stats["history"] = {
            k: [float(x) for x in v] if isinstance(v, list) else v
            for k, v in history.items()
        }
    if test_results:
        stats.update(test_results)
    if extra:
        stats.update(extra)
    out = run_dir / "metadata.txt"
    out.write_text(json.dumps(stats, indent=4, default=str))
    return out


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
