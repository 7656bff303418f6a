"""Host utilities."""

from __future__ import annotations

import logging
import sys


def init_logging(level: int = logging.INFO) -> None:
    """Uniform stderr logging (a copy of
    ``audio_training_tpu/utils/logging.py::init_logging``)."""
    fmt = "%(process)d %(threadName)s:%(levelname)7s %(message)s"
    logging.basicConfig(
        stream=sys.stderr, level=level, format=fmt, datefmt="%Y-%m-%d %H:%M:%S"
    )
