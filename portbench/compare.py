"""The numbers that decide ``correct``, each beside its limit from the
workload file (``limits``).  The limits and the readings they were set
from are in PERF.md.

Training (program against reference):

* ``logit_gap``: the first step's train-mode logits (dropout and all), the
  root-mean-square gap over the spread of the reference's logits across
  clips, as ``logit_rms_gap`` below; infinite where the program's step
  gave no logits or logits of other rows;
* ``loss_gap``: ``|loss - reference loss| / reference loss`` of the first
  step (the later steps' losses carry Adam's first step, which moves
  every parameter by the learning rate whatever the sign's margin, so
  round-off flips whole steps there);
* ``grad_gap``: the median over the leaves (parameters) of the gap between
  the norm of the program's first gradient and the reference's, over the
  larger of that leaf's reference norm and the median leaf's (single
  leaves whose gradient is a sum that all but cancels, such as the mel
  power's exponent and the first layers' shifts, read bf16 noise of 0.1
  to 0.3);
* ``change_gap``: the largest such gap of the norm of each leaf's change
  after the three steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others move under Adam by
  round-off alone): a state left unchanged, or moved twice, reads 1.

Serving (every answer of the window against the reference of its clips):

* ``logit_rms_gap``: the largest root-mean-square gap of an answer's
  logits, over the spread of the reference's logits across its clips (the
  root-mean-square over labels of their standard deviation over clips);
* ``logit_max_gap``: the largest single logit's gap, over that spread.
"""

from __future__ import annotations

import math
import statistics

import torch

GRAD_FLOOR = 1e-3


def memory_peak(device: torch.device, reset: bool = False) -> int:
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def gap_of_norms(prog: dict, ref: dict, names, leaf: str) -> float:
    """``leaf``'s gap of norms over the larger of its reference norm and
    the median of ``names``' reference norms.  A leaf missing on the
    program's side (the optimizer holds no state for it) reads as a norm
    of 0."""
    median = statistics.median(ref[n] for n in names)
    return abs(prog.get(leaf, 0.0) - ref[leaf]) / max(ref[leaf], median)


def training_numbers(prog: dict, ref: dict) -> dict:
    floor = GRAD_FLOOR * statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= floor]
    return {
        "logit_gap": logit_gap(prog["logits"], ref["logits"]),
        "loss_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": statistics.median(
            gap_of_norms(prog["grad"], ref["grad"], ref["grad"], n)
            for n in ref["grad"]),
        "change_gap": max(gap_of_norms(prog["change"], ref["change"], moved,
                                       n) for n in moved),
    }


def spread(ref: torch.Tensor) -> float:
    """The root-mean-square over labels of the logits' standard deviation
    over clips."""
    return ref.std(dim=0).pow(2).mean().sqrt().item()


def logit_gap(logits: torch.Tensor | None, ref: torch.Tensor) -> float:
    if logits is None or logits.shape != ref.shape:
        return math.inf
    return (logits.float() - ref).pow(2).mean().sqrt().item() / spread(ref)


def serving_numbers(answers: list, ref: dict) -> dict:
    """``answers``: (pool batch, logits on the host) of each request;
    ``ref``: pool batch -> the reference's float32 logits on the host."""
    rms_gap = max_gap = 0.0
    for k, logits in answers:
        rms_gap = max(rms_gap, logit_gap(logits, ref[k]))
        max_gap = max(max_gap, (logits.float() - ref[k]).abs().max().item()
                      / spread(ref[k]))
    return {"logit_rms_gap": rms_gap, "logit_max_gap": max_gap}


def with_limits(numbers: dict, limits: dict) -> list[tuple[str, float, float]]:
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise ValueError(f"the workload file sets no limit for {missing}; "
                         "PERF.md says why")
    return [(n, v, limits[n]) for n, v in numbers.items()]


def passed(checks: list) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)
