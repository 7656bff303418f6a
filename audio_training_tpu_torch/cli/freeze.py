"""Deployment-freeze CLI — ``python -m audio_training_tpu_torch.cli.freeze
<run_dir> <out_dir> [-w val-loss]`` (port of
``audio_training_tpu/cli/freeze.py``; reference: freezemodel.py:103-131).
Host only: it copies the weights file and rewrites the metadata."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from audio_training_tpu_torch.infer.freeze import freeze
from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model", help="Run directory to freeze")
    parser.add_argument("out_dir", help="Deployment output dir")
    parser.add_argument("-w", "--weights", default="val-loss",
                        help="Weights file to package, without its .pt "
                             "suffix (chkpt.pt when absent)")
    parser.add_argument("--label-paths", default=None,
                        help="label_paths.json for API display names")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    out = freeze(Path(args.model), Path(args.out_dir),
                 checkpoint=args.weights, label_paths_file=args.label_paths)
    logging.info("Frozen deployment written to %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
