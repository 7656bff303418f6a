"""Evaluation CLI — ``python -m audio_training_tpu_torch.cli.evaluate
{weak,strong,compare,mean,thresholds} ...`` (port of
``audio_training_tpu/cli/evaluate.py``; reference: evaluate.py +
confusioncompare.py CLIs).

``weak`` and ``strong`` load a run or deployment directory and run its
Predictor on the card unless given ``--device cpu``; ``compare``, ``mean``
and ``thresholds`` read saved confusions and raw dumps on the host."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    weak = sub.add_parser("weak", help="Evaluate a weakly-labelled directory")
    weak.add_argument("model", help="Run/deployment dir")
    weak.add_argument("dir", help="Directory of <label>/<audio> files")
    weak.add_argument("-w", "--weights", default="val-loss")
    weak.add_argument("--threshold", type=float, default=0.7)
    weak.add_argument("--workers", type=int, default=8,
                      help="Preprocessing processes (reference Pool size, "
                           "evaluate.py:81)")
    weak.add_argument("--out", default="./confusions/weak")
    weak.add_argument("--device", default="cuda",
                      help="torch device of the Predictor (cuda or cpu)")

    strong = sub.add_parser(
        "strong",
        help="Evaluate a strong-label (sidecar-annotated) directory "
             "(audiomodel.evaluate_dir parity)",
    )
    strong.add_argument("model", help="Run/deployment dir")
    strong.add_argument("dir", help="Directory of <rec>.{wav,txt} pairs")
    strong.add_argument("-w", "--weights", default="val-loss")
    strong.add_argument("--threshold", type=float, default=0.7)
    strong.add_argument("--workers", type=int, default=1,
                        help="Preprocess pool size (reference uses 8)")
    strong.add_argument("--rec-ids", default=None,
                        help="Comma-separated recording ids to keep")
    strong.add_argument("--out", default="./confusions/strong")
    strong.add_argument("--device", default="cuda",
                        help="torch device of the Predictor (cuda or cpu)")

    comp = sub.add_parser("compare", help="Compare two confusion .npy files")
    comp.add_argument("first_confusion")
    comp.add_argument("second_confusion")

    mean = sub.add_parser(
        "mean",
        help="Weighted-mean ensemble confusion from two+ raw dumps of the "
             "same test stream (audiomodel --model_2, "
             "audiomodel.py:1363-1386)",
    )
    mean.add_argument("raw_npys", nargs="+",
                      help="<confusion>-raw.npy dumps, main model first")
    mean.add_argument("--weights", default=None,
                      help="Comma-separated model weights "
                           "(default 0.6,0.4 for two models)")
    mean.add_argument("--threshold", type=float, default=0.7)
    mean.add_argument("--out", default="./confusions/mean-model")

    thr = sub.add_parser("thresholds",
                         help="Best per-class thresholds from a raw dump")
    thr.add_argument("raw_npy", help="<confusion>-raw.npy dump")
    thr.add_argument("--out", default=None,
                     help="Write the thresholds table as JSON (feed to "
                          "predict --thresholds-json)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    if args.cmd == "weak":
        from audio_training_tpu_torch.cli.predict import load_predictor
        from audio_training_tpu_torch.eval import evaluate_weakly_labelled_dir

        predictor, _ = load_predictor(Path(args.model), args.weights,
                                      device=args.device)
        result = evaluate_weakly_labelled_dir(
            predictor, args.dir, out_prefix=args.out,
            threshold=args.threshold, workers=args.workers,
        )
        correct = int(np.trace(result.mean_cm))
        total = int(result.mean_cm.sum())
        logging.info("mean-agg accuracy: %s/%s", correct, total)
        return 0
    if args.cmd == "strong":
        from audio_training_tpu_torch.cli.predict import load_predictor
        from audio_training_tpu_torch.eval.strong import evaluate_strong_dir

        predictor, meta = load_predictor(Path(args.model), args.weights,
                                         device=args.device)
        rec_ids = None
        if args.rec_ids:
            rec_ids = [int(r) for r in args.rec_ids.split(",")]
        result = evaluate_strong_dir(
            predictor, args.dir, out_prefix=args.out,
            threshold=args.threshold, workers=args.workers,
            remapped_labels=meta.get("remapped_labels"), rec_ids=rec_ids,
        )
        for name, cm in (("mean", result.mean_cm), ("max", result.max_cm),
                         ("counts", result.counts_cm)):
            correct = int(np.trace(cm))
            total = int(cm.sum())
            logging.info("%s-agg accuracy: %s/%s", name, correct, total)
        return 0
    if args.cmd == "mean":
        from audio_training_tpu_torch.eval import (
            load_raw_predictions,
            mean_model_confusion,
            save_confusion,
        )

        dumps = [load_raw_predictions(p) for p in args.raw_npys]
        weights = (
            [float(w) for w in args.weights.split(",")]
            if args.weights else None
        )
        cm, out_labels, _ = mean_model_confusion(
            dumps, weights=weights, threshold=args.threshold
        )
        save_confusion(cm, out_labels, args.out)
        correct = int(np.trace(cm))
        total = int(cm.sum())
        logging.info("mean-model accuracy: %s/%s -> %s", correct, total,
                     args.out)
        return 0
    if args.cmd == "compare":
        import json

        from audio_training_tpu_torch.eval import compare_confusions

        first = Path(args.first_confusion)
        second = Path(args.second_confusion)
        first_meta = json.loads((first.parent / "metadata.txt").read_text())
        second_meta = json.loads((second.parent / "metadata.txt").read_text())
        res = compare_confusions(
            np.load(first), first_meta["ebird_labels"],
            np.load(second), second_meta["ebird_labels"],
        )
        for label, d in res.per_label.items():
            logging.info(
                "%s: %s%% vs %s%% (diff %s, most wrong %s/%s)",
                label, d["first_acc"], d["second_acc"], d["sample_diff"],
                d["first_most_wrong"], d["second_most_wrong"],
            )
        logging.info(
            "total diff %s (%.1f%%), incorrect score %.1f%%, winner: %s",
            res.total_diff, res.accuracy_diff_percent,
            res.incorrect_score_percent, res.winner,
        )
        return 0
    if args.cmd == "thresholds":
        from audio_training_tpu_torch.eval import best_thresholds, load_raw_predictions

        dump = load_raw_predictions(args.raw_npy)
        th = best_thresholds(
            (dump["y_true"] > 0.5).astype(int)
            if dump["y_true"].ndim > 1
            else np.eye(len(dump["labels"]))[dump["y_true"].astype(int)],
            dump["y_pred"], dump["labels"],
        )
        for l, t in th.items():
            logging.info("%s: %.3f", l, t)
        if args.out:
            import json as _json

            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(_json.dumps(th, indent=2))
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
