"""Uniform stderr logging (every reference module defines an identical
``init_logging``, e.g. audiomodel.py:2417-2426 — here it exists once)."""

from __future__ import annotations

import logging
import sys


def init_logging(level: int = logging.INFO) -> None:
    fmt = "%(process)d %(threadName)s:%(levelname)7s %(message)s"
    logging.basicConfig(
        stream=sys.stderr, level=level, format=fmt, datefmt="%Y-%m-%d %H:%M:%S"
    )
