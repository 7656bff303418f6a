"""Offline mixup dataset CLI (reference: createaugmentedset.py): read built
shards, eagerly mix record pairs, write new shards.

A copy of ``audio_training_tpu/cli/augment.py`` with the port's imports.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from audio_training_tpu_torch.data.augmented import create_augmented_set
from audio_training_tpu_torch.data.pipeline import find_shards
from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="training-data directory")
    parser.add_argument("out_dir", help="Output directory for mixed shards")
    parser.add_argument("--split", default="train")
    parser.add_argument("--records-per-shard", type=int, default=1000)
    parser.add_argument("--min-weight", type=float, default=0.2)
    parser.add_argument("--max-weight", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    shards = find_shards(args.data_dir, args.split)
    if not shards:
        logging.error("no shards in %s/%s", args.data_dir, args.split)
        return 1
    n = create_augmented_set(
        shards, Path(args.out_dir),
        records_per_shard=args.records_per_shard,
        weight_range=(args.min_weight, args.max_weight),
        seed=args.seed,
    )
    logging.info("wrote %s mixed records to %s", n, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
