"""Inference CLI — ``python -m audio_training_tpu_torch.cli.predict --file
x.wav <run_dir>`` (port of ``audio_training_tpu/cli/predict.py``;
reference: ``python predict.py --file x.wav <model>``, predict.py:726-1019).

The run directory holds ``metadata.txt`` and the port's weights file
``<weights>.pt`` (``train/checkpoints.py``).  The Predictor runs on the
CUDA card unless given ``--device cpu``.

Ported flags: ``--file``, ``--dir``, ``--weights``, ``--threshold``,
``--aggregation``, ``--thresholds-json``, ``--json-out``.  The JAX CLI's
other flags are accepted by the parser only to exit with an error naming
the ROADMAP item that ports them; none is ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.utils import init_logging

_QUEUED = "ROADMAP.md queue item 3 (the rest of long-recording inference)"
# flag -> what ports it
_UNPORTED = {
    "--denoise": "ops/denoise.py::spectral_gate",
    "--grid": "infer/ebirdgrid.py",
    "--lat": "infer/ebirdgrid.py",
    "--lng": "infer/ebirdgrid.py",
    "--month": "infer/ebirdgrid.py",
    "--embedding-model": "infer/embeddings.py",
    "--yamnet-model": "infer/embeddings.py",
    "--folder-eval": "infer/folder.py",
    "--test-split": "infer/folder.py",
}
AUDIO_SUFFIXES = (".wav", ".mp3", ".m4a", ".flac")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model", help="Run/deployment directory")
    parser.add_argument("--file", help="Audio file to predict")
    parser.add_argument("-d", "--dir", help="Directory of files to predict")
    parser.add_argument("-w", "--weights", default="val-loss",
                        help="Weights file name within the run dir, "
                             "without its .pt suffix")
    parser.add_argument("--threshold", type=float, default=0.7)
    parser.add_argument("--aggregation", default="mean",
                        choices=["mean", "max", "votes"])
    parser.add_argument("--json-out", default=None,
                        help="Write track predictions JSON here")
    parser.add_argument("--thresholds-json", default=None,
                        help="Per-class thresholds JSON (label -> threshold)"
                             " (preeval.py:143-221 + predict.py:503 parity)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Predictor (cuda or cpu)")
    for flag in _UNPORTED:
        parser.add_argument(flag, help=argparse.SUPPRESS,
                            action="count" if flag == "--denoise" else "store")
    args = parser.parse_args(argv)
    for flag, module in _UNPORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet: it comes with {module}, "
                         f"{_QUEUED}")
    return args


def weights_path(model_dir: Path, weights: str) -> Path:
    """The port's weights file of a run dir: ``<weights>.pt``, else the
    frozen-deployment ``audioModel.pt``, else the resume ``chkpt.pt``."""
    from audio_training_tpu_torch.train.checkpoints import SUFFIX

    for name in (weights, "audioModel", "chkpt"):
        path = model_dir / f"{name}{SUFFIX}"
        if path.exists():
            return path
    if (model_dir / weights).is_dir():
        raise FileNotFoundError(
            f"{model_dir / weights} is an orbax checkpoint of the JAX "
            f"package; the port reads its own {SUFFIX} files only (reading "
            f"orbax checkpoints is queued in {_QUEUED})"
        )
    raise FileNotFoundError(f"no {weights}{SUFFIX} weights file in {model_dir}")


def load_predictor(model_dir: Path, weights: str, aggregation: str = "mean",
                   threshold: float = 0.7, device: str = "cuda"):
    """Reconstruct a Predictor from a run/deployment dir
    (predict.py:743-816: model + metadata.txt)."""
    from audio_training_tpu_torch.config import InferenceConfig
    from audio_training_tpu_torch.infer.predictor import Predictor
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.train.checkpoints import load_state_dict
    from audio_training_tpu_torch.train.metadata import (
        featurizer_from_metadata,
        load_metadata,
    )

    meta = load_metadata(model_dir)
    cfg = featurizer_from_metadata(meta)
    labels = meta.get("ebird_labels", meta.get("labels"))
    model_name = meta.get("name", "badwinner2")
    multi_label = meta.get("multi_label", True)
    channels = int(meta.get("channels", 1))
    # only badwinner2 takes the mel height; a backbone reads any image
    extra = ({"n_mels": cfg.n_mels} if model_name.lower() == "badwinner2"
             else {})
    module = build_model(model_name, num_labels=len(labels), logits_only=True,
                         multi_label=multi_label, in_channels=channels,
                         **extra).module
    module.load_state_dict(load_state_dict(weights_path(model_dir, weights)))
    infer_cfg = InferenceConfig(threshold=threshold, aggregation=aggregation)
    return Predictor(
        module.to(device), labels, cfg, infer_cfg,
        model_name=model_name,
        channels=channels,
        mean_sub=bool(meta.get("mean_sub", False)),
        db_scale=bool(meta.get("db_scale", False)),
        multi_label=multi_label,
        device=device,
    ), meta


def predict_file(predictor, path: Path, threshold=0.7) -> list[dict]:
    """Per-track meta dicts of one recording, predictions included."""
    from audio_training_tpu_torch.corpus.audioio import load_recording

    frames, sr = load_recording(path, target_sr=predictor.cfg.sr)
    tracks, _ = predictor.predict_recording(frames, sr, threshold=threshold)
    return [t.get_meta() for t in tracks]


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    predictor, _ = load_predictor(Path(args.model), args.weights,
                                  args.aggregation, args.threshold,
                                  device=args.device)

    # scalar default, overridden per class by a thresholds JSON
    threshold = args.threshold
    if args.thresholds_json:
        table = json.loads(Path(args.thresholds_json).read_text())
        threshold = np.array(
            [float(table.get(l, args.threshold)) for l in predictor.labels],
            np.float32,
        )

    if args.file:
        files = [Path(args.file)]
    elif args.dir:
        files = sorted(f for f in Path(args.dir).iterdir()
                       if f.suffix.lower() in AUDIO_SUFFIXES)
    else:
        logging.error("Need --file or --dir")
        return 1

    all_results = {}
    for f in files:
        track_meta = predict_file(predictor, f, threshold)
        for tm in track_meta:
            for p in tm["predictions"]:
                logging.info(
                    "%s track %.1f-%.1fs: %s %s",
                    f.name, tm["start"], tm["end"],
                    p["labels"] or p.get("raw_tag"),
                    p["confidences"] or p.get("raw_confidence"),
                )
        all_results[str(f)] = track_meta
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(all_results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
