"""The plain side of the benchmark: plain PyTorch and NumPy, written from
the definitions.  Nothing in this package imports the program or JAX.

A reference model is a module of this package named as the configuration's
``reference`` key, with ``spec(num_labels, geometry, channels)`` (the name,
shape and initialisation of every tensor, in the program's ``state_dict``
names) and ``forward(ctx, tensors, x)`` (NCHW float32 in, logits out).
"""

from __future__ import annotations

import importlib

STATS = ("stat_mean", "stat_var")  # the inits of buffers, not parameters


def model(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def split(spec: list, tensors: dict) -> tuple[dict, dict]:
    """(trainable parameters, running statistics) of ``tensors``."""
    params = {n: tensors[n] for n, _, init in spec if init not in STATS}
    stats = {n: tensors[n] for n, _, init in spec if init in STATS}
    return params, stats
