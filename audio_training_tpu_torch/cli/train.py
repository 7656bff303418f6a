"""Training CLI — ``python -m audio_training_tpu_torch.cli.train <run-name>
-d <data>`` (port of ``audio_training_tpu/cli/train.py``; reference:
``python audiomodel.py <run-name> -d <data>``, audiomodel.py:1985-2414).

The flags and defaults are the JAX CLI's, plus ``--device`` (the CUDA card
unless given ``--device cpu``).  A run that needs what the port has not
ported yet (``--backbone-weights``, ``--data-shards`` > 1, a model family
other than badwinner2 and the ported backbones, ``rf-features``) exits 2
with a message naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path

from audio_training_tpu_torch.config import (
    FeaturizerConfig,
    TrainConfig,
    config_from_dict,
)
from audio_training_tpu_torch.utils import init_logging


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("name", help="Run name")
    parser.add_argument("-d", "--data-dir", required=True,
                        help="training-data directory")
    parser.add_argument("--second-dataset-dir", default=None)
    parser.add_argument("--human-dataset-dir", default=None)
    parser.add_argument("--extra-datasets", nargs="*", default=[])
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--model-name", default="badwinner2")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--multi-label", type=str2bool, default=True)
    parser.add_argument("--use-generic-bird", type=str2bool, default=True)
    parser.add_argument("--loss", default="bce",
                        choices=["bce", "cce", "weighted_bce", "soft_f1",
                                 "focal"])
    parser.add_argument("--weighting", action="count",
                        help="Use inverse-frequency class weights")
    parser.add_argument("--epoch-confusion", action="store_true",
                        help="Write a validation confusion matrix artifact "
                             "per epoch (audiomodel.log_confusion_matrix)")
    parser.add_argument("--lme", action="count")
    parser.add_argument("--no-low-samples", action="count",
                        help="Don't use over sampled samples "
                        "(tfdataset.py:728-733)")
    parser.add_argument("--use-bird-tags", action="count",
                        help="Use tracks of generic bird tags (without "
                        "specific birds) in training "
                        "(audiomodel --use_bird_tags)")
    parser.add_argument("--filter-freq", action="count",
                        help="Train on band-passed sample variants when the "
                        "records carry them (build with --add-buttered)")
    parser.add_argument("--random-butter", type=float, default=0.0,
                        help="Probability of picking the band-passed variant "
                        "per visit (reference uses 0.6); 0 = always when "
                        "--filter-freq")
    parser.add_argument("--only-features", action="count")
    parser.add_argument("--morepork-model", action="store_true")
    parser.add_argument("--cross", action="count", help="5-fold CV")
    parser.add_argument("-w", "--weights", default=None,
                        help="Weights file (.pt) to fine-tune from")
    parser.add_argument("--backbone-weights", default=None,
                        help="Local keras.applications weight file (not "
                             "ported yet: exits 2)")
    parser.add_argument("--backbone-weights-custom", action="store_true",
                        help="With --backbone-weights: the weight file came "
                             "from a weights=None keras graph")
    # featurizer flags default to the dataset's training-meta.json values
    # (the build embeds its FeaturizerConfig) so the train-time featurizer
    # matches the shards unless explicitly overridden
    parser.add_argument("--mels", type=int, default=None)
    parser.add_argument("--break-freq", type=float, default=None)
    parser.add_argument("--sr", type=int, default=None)
    parser.add_argument("--n-fft", type=int, default=None)
    parser.add_argument("--hop-length", type=int, default=None)
    parser.add_argument("--fmin", type=float, default=None)
    parser.add_argument("--fmax", type=float, default=None)
    parser.add_argument("--data-shards", type=int, default=1,
                        help="Data-parallel size (devices; only 1 is ported)")
    parser.add_argument("--loader-workers", type=int, default=None,
                        help="Host decode processes for the train split "
                             "(default: AUDIO_TPU_LOADER_WORKERS, else one "
                             "thread)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-c", "--config-file", default=None,
                        help="JSON TrainConfig overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def featurizer_for(args) -> FeaturizerConfig:
    """The build's config from training-meta.json where available,
    production defaults otherwise, with the flags' overrides."""
    base = FeaturizerConfig()
    meta_path = Path(args.data_dir) / "training-meta.json"
    if meta_path.exists():
        base = config_from_dict(FeaturizerConfig,
                                json.loads(meta_path.read_text()))
    overrides = {
        "n_mels": args.mels, "break_freq": args.break_freq, "sr": args.sr,
        "n_fft": args.n_fft, "hop_length": args.hop_length,
        "fmin": args.fmin, "fmax": args.fmax,
    }
    overrides = {k: v for k, v in overrides.items() if v is not None}
    # low-nfft mel reduction (tfdataset.py:448-453): whenever the EFFECTIVE
    # n_fft drops below 2048 without an explicit --mels, cap at 96 mels — a
    # 160-band filterbank over <=1024 bins leaves many filters empty.  A
    # meta-provided geometry is already consistent, so the rule only fires
    # when n_fft is explicitly overridden (or no meta exists).
    if (
        "n_mels" not in overrides
        and ("n_fft" in overrides or not meta_path.exists())
        and overrides.get("n_fft", base.n_fft) < 2048
        and base.n_mels > 96
    ):
        overrides["n_mels"] = 96
    return dataclasses.replace(base, **overrides)


def main(argv=None) -> int:
    init_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    from audio_training_tpu_torch.train.harness import (
        cross_fold_train,
        train_run,
        unported_reason,
    )

    cfg_kwargs = dict(
        model_name=args.model_name, batch_size=args.batch_size,
        learning_rate=args.lr, epochs=args.epochs,
        multi_label=args.multi_label,
        use_generic_bird=args.use_generic_bird, loss=args.loss,
        use_weighting=bool(args.weighting),
        no_low_samples=bool(args.no_low_samples),
        use_bird_tags=bool(args.use_bird_tags),
        filter_freq=bool(args.filter_freq),
        random_butter=args.random_butter,
        epoch_confusion=args.epoch_confusion,
        num_data_shards=args.data_shards, seed=args.seed,
        loader_workers=args.loader_workers,
    )
    if args.config_file:
        cfg_kwargs.update(json.loads(Path(args.config_file).read_text()))
    train_cfg = config_from_dict(TrainConfig, cfg_kwargs)
    reason = unported_reason(train_cfg, args.backbone_weights)
    if reason is not None:
        parser.error(f"not ported yet: {reason}")

    data_dirs = [args.data_dir]
    if args.second_dataset_dir:
        data_dirs.append(args.second_dataset_dir)
    if args.human_dataset_dir:
        data_dirs.append(args.human_dataset_dir)
    data_dirs.extend(args.extra_datasets)

    common = dict(
        data_dirs=data_dirs,
        checkpoint_root=args.checkpoint_dir,
        train_cfg=train_cfg,
        featurizer=featurizer_for(args),
        steps_per_epoch=args.steps_per_epoch,
        only_features=bool(args.only_features),
        morepork_model=args.morepork_model,
        weights=args.weights,
        device=args.device,
    )
    if args.cross:
        results = cross_fold_train(run_name=args.name, **common)
        for r in results:
            logging.info("fold %s: %s", r.run_dir, r.test_metrics)
    else:
        result = train_run(run_name=args.name, **common)
        logging.info("Run complete: %s test=%s", result.run_dir,
                     result.test_metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
