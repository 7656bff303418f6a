"""Collective audit for the data-parallel claim (the port of
``audio_training_tpu/parallel/hlo_audit.py`` without its HLO parser).

JAX reads the collectives of the compiled SPMD step from its HLO text.
The port issues its collectives itself, each through
:mod:`audio_training_tpu_torch.parallel.collectives`, which records the
kind (HLO's mnemonic) and the elements of each into every open
:func:`counting` context: DistributedDataParallel's gradient buckets (its
comm hook), the train-mode BatchNorm and min-max all-reduces, the epoch
metrics, broadcasts and the Predictor's gather.  DistributedDataParallel's
own one-time collectives (the parameter check and broadcast when it is
built, the bucket order after its first backward) do not pass through the
hook and are not counted: audit a step after the first.

The claims are JAX's: a step all-reduces at least every parameter (the
gradients are synced) and no more than ``params + 4 * bn + 4096`` elements
(nothing activation-sized), with no other kind of collective; the sharded
forward issues no collective but scalar-sized all-reduces (the PCEN
min-max), and the only gather is the ``(n, labels)`` probabilities.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

_OPEN: list["CollectiveInventory"] = []


@dataclass
class CollectiveInventory:
    """Per-collective-kind list of element counts."""

    ops: dict[str, list[int]] = field(default_factory=dict)

    @property
    def kinds(self) -> set[str]:
        return set(self.ops)

    def total_elements(self, kind: str) -> int:
        return sum(self.ops.get(kind, []))

    def count(self, kind: str) -> int:
        return len(self.ops.get(kind, []))

    def summary(self) -> str:
        if not self.ops:
            return "no collectives"
        return "; ".join(
            f"{k}: {self.count(k)} ops, {self.total_elements(k)} elements"
            for k in sorted(self.ops)
        )


def record(kind: str, elements: int) -> None:
    """Count one collective of ``kind`` over ``elements`` elements."""
    for inv in _OPEN:
        inv.ops.setdefault(kind, []).append(int(elements))


@contextlib.contextmanager
def counting():
    """Yield a :class:`CollectiveInventory` that records every collective
    this process issues until the context closes."""
    inv = CollectiveInventory()
    _OPEN.append(inv)
    try:
        yield inv
    finally:
        _OPEN.remove(inv)


def audit_dp_train_step(
    inv: CollectiveInventory,
    param_elements: int,
    batch_stat_elements: int = 0,
    scalar_slack: int = 4096,
) -> CollectiveInventory:
    """Assert a DP train step's collectives are the per-step-constant set:
    gradient all-reduces covering every parameter, plus BatchNorm partial
    sums and scalars, and nothing activation-sized or gather-shaped.
    ``batch_stat_elements`` counts the running statistics (mean and var).
    Raises AssertionError with the inventory otherwise; returns it."""
    extra = inv.kinds - {"all-reduce"}
    assert not extra, (
        f"unexpected collective kinds in DP step: {sorted(extra)} "
        f"({inv.summary()})"
    )
    total = inv.total_elements("all-reduce")
    assert total >= param_elements, (
        f"gradient all-reduce coverage too small: {total} elements reduced "
        f"< {param_elements} params — gradients are not being synced"
    )
    # BN statistics sync as per-channel [sum x, sum x^2] and a row count,
    # forward and backward (and again in a rematerialized forward): 4x
    budget = param_elements + 4 * batch_stat_elements + scalar_slack
    assert total <= budget, (
        f"all-reduce volume {total} elements exceeds the per-step-constant "
        f"budget {budget} (params {param_elements} + 4*bn "
        f"{batch_stat_elements} + slack) — an activation is being reduced "
        f"({inv.summary()})"
    )
    return inv


def audit_dp_inference(inv: CollectiveInventory,
                       gathered_elements: int = 0,
                       scalar_slack: int = 64) -> CollectiveInventory:
    """Assert a mesh-sharded inference pass is embarrassingly parallel: at
    most scalar-sized all-reduces (the PCEN global min-max is a legitimate
    cross-batch scalar reduce), and all-gathers of exactly
    ``gathered_elements`` (the ``(n, labels)`` probabilities; 0 for a bare
    forward)."""
    extra = inv.kinds - {"all-reduce", "all-gather"}
    assert not extra, (
        f"unexpected collective kinds in DP inference: {sorted(extra)} "
        f"({inv.summary()})"
    )
    total = inv.total_elements("all-reduce")
    assert total <= scalar_slack, (
        f"DP inference all-reduces {total} elements (> {scalar_slack}): "
        f"activations are crossing devices ({inv.summary()})"
    )
    gathered = inv.total_elements("all-gather")
    assert gathered == gathered_elements, (
        f"DP inference gathers {gathered} elements, not the "
        f"{gathered_elements} of the probabilities ({inv.summary()})"
    )
    return inv
