"""Inference CLI — ``python -m audio_training_tpu_torch.cli.predict --file
x.wav <run_dir>`` (port of ``audio_training_tpu/cli/predict.py``;
reference: ``python predict.py --file x.wav <model>``, predict.py:726-1019).

The run directory holds ``metadata.txt`` and the port's weights file
``<weights>.pt`` (``train/checkpoints.py``); a frozen deployment
(``cli/freeze``) holds ``audioModel.pt``.  The Predictor runs on the CUDA
card unless given ``--device cpu``.

Every flag of the JAX CLI is known.  ``--embedding-model`` /
``--embedding-kind`` / ``--yamnet-model`` are not ported and exit 2 with
their reason (they load TensorFlow saved models).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.utils import init_logging

_ITEM = ('ROADMAP.md queue 1, "Evaluation, deployment and the rest of '
         'long-recording inference"')
_TENSORFLOW = ("loads a TensorFlow saved model (infer/embeddings.py), and the "
               "port does not depend on TensorFlow")
# flag -> why it exits 2
_UNPORTED = {
    "--embedding-model": _TENSORFLOW,
    "--embedding-kind": _TENSORFLOW,
    "--yamnet-model": _TENSORFLOW,
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
    parser.add_argument("--grid", default=None,
                        help="species_per_square.json for geo masking")
    parser.add_argument("--lat", type=float, default=None)
    parser.add_argument("--lng", type=float, default=None)
    parser.add_argument("--month", type=int, default=None)
    parser.add_argument("--json-out", default=None,
                        help="Write track predictions JSON here")
    parser.add_argument("--denoise", action="count",
                        help="Spectral-gate denoise before detection "
                             "(predict.denoise_spec parity)")
    parser.add_argument("--thresholds-json", default=None,
                        help="Per-class thresholds JSON (label -> threshold)"
                             " (preeval.py:143-221 + predict.py:503 parity)")
    parser.add_argument("--folder-eval", default=None,
                        help="Score best_track-annotated recordings under "
                             "this dir (predict.predict_on_folder parity)")
    parser.add_argument("--workers", type=int, default=1,
                        help="Preprocessing processes for --folder-eval")
    parser.add_argument("--test-split", default=None,
                        help="Pinned split JSON: evaluate the held-out test "
                             "recordings (predict.predict_on_test parity); "
                             "requires --data-dir")
    parser.add_argument("--data-dir", default=None,
                        help="Corpus dir for --test-split")
    parser.add_argument("--confusion-out", default="./confusions/test-split",
                        help="Confusion output prefix for --test-split")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Predictor (cuda or cpu)")
    for flag in _UNPORTED:
        parser.add_argument(flag, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for flag, reason in _UNPORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported: it {reason}")
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
            f"orbax checkpoints stays open in {_ITEM})"
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
    module = build_model(model_name, num_labels=len(labels), logits_only=True,
                         multi_label=multi_label, n_mels=cfg.n_mels,
                         mel_frames=cfg.mel_frames,
                         in_channels=channels).module
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


def predict_file(predictor, path: Path, grid_meta=None, lat=None, lng=None,
                 month=None, threshold=0.7, denoise=False) -> list[dict]:
    """Per-track meta dicts of one recording, predictions included.
    ``denoise`` runs ``ops/denoise.spectral_gate`` on the Predictor's device
    before detection; with ``grid_meta`` and ``lat`` each track's labels are
    masked to the species seen around (lat, lng) in ``month``
    (``infer/ebirdgrid.apply_species_mask``)."""
    import torch

    from audio_training_tpu_torch.corpus.audioio import load_recording
    from audio_training_tpu_torch.infer.ebirdgrid import apply_species_mask

    frames, sr = load_recording(path, target_sr=predictor.cfg.sr)
    if denoise:
        from audio_training_tpu_torch.ops.denoise import spectral_gate

        x = torch.as_tensor(frames[None], dtype=torch.float32,
                            device=predictor.device)
        frames = spectral_gate(x)[0].cpu().numpy()
    tracks, results = predictor.predict_recording(frames, sr,
                                                  threshold=threshold)
    for r in results:
        if r is not None and grid_meta is not None and lat is not None:
            # re-apply the geo mask to the aggregated confidences
            probs = np.zeros(len(predictor.labels), np.float32)
            for l, c in zip(r.labels, r.confidences):
                probs[predictor.labels.index(l)] = c / 100
            masked = apply_species_mask(probs, predictor.labels, grid_meta,
                                        lat, lng, month)
            kept = np.flatnonzero(masked > 0)
            r.labels = [predictor.labels[i] for i in kept]
            r.confidences = [round(float(masked[i]) * 100) for i in kept]
    # the metas are read after the mask (the JAX CLI reads them before it,
    # so its output keeps the unmasked labels)
    return [t.get_meta() for t in tracks]


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    predictor, meta = load_predictor(Path(args.model), args.weights,
                                  args.aggregation, args.threshold,
                                  device=args.device)
    grid_meta = None
    if args.grid:
        grid_meta = json.loads(Path(args.grid).read_text())

    # scalar default, overridden per class by a thresholds JSON
    threshold = args.threshold
    if args.thresholds_json:
        table = json.loads(Path(args.thresholds_json).read_text())
        threshold = np.array(
            [float(table.get(l, args.threshold)) for l in predictor.labels],
            np.float32,
        )

    if args.folder_eval:
        from audio_training_tpu_torch.infer.folder import predict_on_folder

        result = predict_on_folder(predictor, args.folder_eval,
                                   threshold=threshold,
                                   workers=args.workers)
        if args.json_out:
            Path(args.json_out).write_text(json.dumps(
                {"accuracy": result.accuracy,
                 "total_files": result.total_files,
                 "total_correct": result.total_correct,
                 "per_file": result.per_file}, indent=2))
        return 0

    if args.test_split:
        if not args.data_dir:
            logging.error("--test-split requires --data-dir")
            return 1
        from audio_training_tpu_torch.infer.folder import predict_on_test

        cm, labels = predict_on_test(
            predictor, args.test_split, args.data_dir,
            confusion_file=args.confusion_out,
            remapped_labels=meta.get("remapped_labels"),
        )
        correct = int(cm.trace())
        total = int(cm.sum())
        logging.info("test split: %s/%s correct", correct, total)
        return 0

    if args.file:
        files = [Path(args.file)]
    elif args.dir:
        files = sorted(f for f in Path(args.dir).iterdir()
                       if f.suffix.lower() in AUDIO_SUFFIXES)
    else:
        logging.error("Need --file, --dir, --folder-eval or --test-split")
        return 1

    all_results = {}
    for f in files:
        track_meta = predict_file(
            predictor, f, grid_meta, args.lat, args.lng, args.month,
            threshold, denoise=bool(args.denoise))
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
