"""Inference CLI — ``python -m audio_training_tpu_torch.cli.predict --file
x.wav <run_dir>`` (port of ``audio_training_tpu/cli/predict.py``;
reference: ``python predict.py --file x.wav <model>``, predict.py:726-1019).

The run directory holds ``metadata.txt`` and the port's weights file
``<weights>.pt`` (``train/checkpoints.py``); a frozen deployment
(``cli/freeze``) holds ``audioModel.pt``.  The Predictor runs on the CUDA
card unless given ``--device cpu``.

Every flag of the JAX CLI is known.  An ``embeddings`` run predicts
through ``infer/embeddings.EmbeddingPredictor`` with ``--embedding-model``
(a local Perch or YAMNet saved model, ``--embedding-kind``), and
``--yamnet-model`` adds a speech score per file; these three load
TensorFlow saved models, so they need TensorFlow where they run, as in the
JAX package (the card's machine has none).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.utils import init_logging

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
    parser.add_argument("--embedding-model", default=None,
                        help="Local saved-model path for the embedding "
                             "extractor when the run is an 'embeddings' "
                             "linear probe (predict.py:380-396 parity)")
    parser.add_argument("--embedding-kind", default="perch",
                        choices=["perch", "yamnet"],
                        help="Embedding extractor family for "
                             "--embedding-model (chirp=perch)")
    parser.add_argument("--yamnet-model", default=None,
                        help="Local YAMNet saved-model path: adds a speech "
                             "score per file (predict.get_speech_score, "
                             "predict.py:1051)")
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
    return parser.parse_args(argv)


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
            f"package; the port reads its own {SUFFIX} files only (orbax "
            f"imports JAX, which the port does not; convert the variables "
            f"with models/convert.state_dict_from_flax)"
        )
    raise FileNotFoundError(f"no {weights}{SUFFIX} weights file in {model_dir}")


def load_predictor(model_dir: Path, weights: str, aggregation: str = "mean",
                   threshold: float = 0.7, embedding_model: str | None = None,
                   embedding_kind: str = "perch", device: str = "cuda"):
    """Reconstruct a Predictor from a run/deployment dir
    (predict.py:743-816: model + metadata.txt).  An ``embeddings`` run
    yields an :class:`EmbeddingPredictor` over the chirp/yamnet extractor
    (predict.py:380-396), which raises ``RuntimeError`` without a loadable
    ``embedding_model``."""
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

    if model_name == "embeddings":
        from audio_training_tpu_torch.infer.embeddings import (
            EmbeddingPredictor,
            PerchModel,
            YamnetModel,
        )

        embedder = (PerchModel(embedding_model) if embedding_kind == "perch"
                    else YamnetModel(embedding_model))
        if not embedder.available:
            raise RuntimeError(
                "an 'embeddings' run needs --embedding-model pointing at a "
                f"local {embedding_kind} saved model"
            )
        return EmbeddingPredictor(
            embedder, module, labels, cfg, infer_cfg,
            multi_label=multi_label, device=device,
        ), meta

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
                 month=None, threshold=0.7, denoise=False,
                 speech_scorer=None) -> tuple[list[dict], float | None]:
    """Per-track meta dicts of one recording, predictions included, and its
    speech score (None without a ``speech_scorer``, a ``YamnetModel``).
    The speech score resamples the already-decoded frames
    (predict.get_speech_score, predict.py:1051).  ``denoise`` runs
    ``ops/denoise.spectral_gate`` on the Predictor's device before
    detection; with ``grid_meta`` and ``lat`` each track's labels are
    masked to the species seen around (lat, lng) in ``month``
    (``infer/ebirdgrid.apply_species_mask``)."""
    import torch

    from audio_training_tpu_torch.corpus.audioio import load_recording, resample
    from audio_training_tpu_torch.infer.ebirdgrid import apply_species_mask

    frames, sr = load_recording(path, target_sr=predictor.cfg.sr)
    speech_score = None
    if speech_scorer is not None:
        speech_score = speech_scorer.speech_score(
            resample(frames, sr, speech_scorer.sample_rate))
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
    return [t.get_meta() for t in tracks], speech_score


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    predictor, meta = load_predictor(
        Path(args.model), args.weights, args.aggregation, args.threshold,
        embedding_model=args.embedding_model,
        embedding_kind=args.embedding_kind, device=args.device)
    speech_scorer = None
    if args.yamnet_model:
        from audio_training_tpu_torch.infer.embeddings import YamnetModel

        speech_scorer = YamnetModel(args.yamnet_model)
        if not speech_scorer.available:
            logging.error("could not load YAMNet from %s", args.yamnet_model)
            return 1
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
        track_meta, speech_score = predict_file(
            predictor, f, grid_meta, args.lat, args.lng, args.month,
            threshold, denoise=bool(args.denoise),
            speech_scorer=speech_scorer)
        for tm in track_meta:
            for p in tm["predictions"]:
                logging.info(
                    "%s track %.1f-%.1fs: %s %s",
                    f.name, tm["start"], tm["end"],
                    p["labels"] or p.get("raw_tag"),
                    p["confidences"] or p.get("raw_confidence"),
                )
        if speech_score is not None:
            logging.info("%s speech score %.3f", f.name, speech_score)
            track_meta = {"speech_score": speech_score, "tracks": track_meta}
        all_results[str(f)] = track_meta
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(all_results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
