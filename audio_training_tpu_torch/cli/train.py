"""Training CLI — ``python -m audio_training_tpu_torch.cli.train <run-name>
-d <data>`` (port of ``audio_training_tpu/cli/train.py``; reference:
``python audiomodel.py <run-name> -d <data>``, audiomodel.py:1985-2414).

The flags and defaults are the JAX CLI's, plus ``--device`` (the CUDA card
unless given ``--device cpu``).  Every model name trains: the mel families,
``dual-badwinner2`` (two band-limited views on K2), ``merge`` (K1's mel
tower with the stored short / mid features), ``cnn-features`` and
``embeddings`` (stored vectors, no featurizer) and ``rf-features`` (a
scikit-learn random forest on the host).  ``--backbone-weights`` starts a
keras.applications backbone from a local Keras weight file: TensorFlow
builds the source graph, so it needs TensorFlow where the run builds its
model, as in the JAX package.

``--data-shards N`` trains data-parallel over N ranks, as JAX's flag does
over N chips.  Under a launcher (``torchrun``'s or JAX's environment
variables) this process is one rank of the launcher's group; otherwise it
starts N ranks itself, rank r on card r (``--device cpu``: CPU ranks over
gloo).  Fewer cards than N exits 2 with the mesh's message; it never puts
two ranks on one card.  A failing rank makes the command exit 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
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
                        help="Local keras.applications weight file (e.g. a "
                             "'notop' ImageNet h5) to initialize a "
                             "pretrained-backbone model from")
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
                        help="Data-parallel mesh size (ranks, one a card)")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    from audio_training_tpu_torch.train.harness import trains_on_one_device

    train_cfg = train_config(args)
    if train_cfg.num_data_shards > 1:
        from audio_training_tpu_torch.parallel import initialize_distributed
        from audio_training_tpu_torch.parallel.multihost import local_rank

        if initialize_distributed():
            # one rank of a launcher's group
            if args.device != "cpu":
                args.device = f"cuda:{local_rank()}"
        elif not trains_on_one_device(train_cfg.model_name):
            return spawn_ranks(parser, args, train_cfg, argv)
    return run(args, train_cfg)


def train_config(args) -> TrainConfig:
    """The flags' TrainConfig, with ``-c``'s JSON overrides."""
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
    return config_from_dict(TrainConfig, cfg_kwargs)


def spawn_ranks(parser, args, train_cfg, argv) -> int:
    """Start ``num_data_shards`` ranks on this host and train in each:
    rank r on card r over NCCL, or on the CPU over gloo."""
    import torch

    from audio_training_tpu_torch.parallel.mesh import mesh_error
    from audio_training_tpu_torch.parallel.multihost import run_ranks

    n = train_cfg.num_data_shards
    if args.device != "cpu":
        error = mesh_error(n, 1, torch.cuda.device_count())
        if error is not None:
            parser.error(error)
    try:
        run_ranks(_rank_main, n, args=(argv, args.device),
                  backend="gloo" if args.device == "cpu" else "nccl")
    except RuntimeError as e:
        logging.error("data-parallel training failed: %s", e)
        return 1
    return 0


def _rank_main(rank: int, argv: list[str], device: str) -> None:
    init_logging()
    args = build_parser().parse_args(argv)
    args.device = "cpu" if device == "cpu" else f"cuda:{rank}"
    run(args, train_config(args))


def run(args, train_cfg: TrainConfig) -> int:
    """Train as ``args`` and ``train_cfg`` say, in this process."""
    from audio_training_tpu_torch.parallel.multihost import on_rank_zero
    from audio_training_tpu_torch.train.harness import (
        cross_fold_train,
        train_random_forest,
        train_run,
    )

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
        backbone_weights=args.backbone_weights,
        backbone_imagenet_stats=not args.backbone_weights_custom,
        device=args.device,
    )
    if train_cfg.model_name == "rf-features":
        # on one device: under a launcher's group, on rank 0
        result = on_rank_zero(lambda: train_random_forest(
            data_dirs, args.name, checkpoint_root=args.checkpoint_dir,
            train_cfg=train_cfg,
        ))
        logging.info("Random forest complete: %s %s", result.run_dir,
                     result.history)
        return 0
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
