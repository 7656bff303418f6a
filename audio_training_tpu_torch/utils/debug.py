"""Pipeline debug checker — tfdataset.main / debug_labels parity
(tfdataset.py:1345-1644): iterate the full preprocessing pipeline validating
every example for NaN/Inf, out-of-range values, and constant windows, and
report label-mapping coverage.

A copy of ``audio_training_tpu/utils/debug.py`` with the port's imports.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class PipelineCheckResult:
    checked: int = 0
    nan_count: int = 0
    out_of_range: int = 0
    constant: int = 0
    label_counts: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.nan_count == 0 and self.constant == 0


def check_pipeline(
    batches,
    labels: list[str],
    value_range: tuple[float, float] = (-1.0, 1.0),
    max_batches: int | None = None,
) -> PipelineCheckResult:
    """Validate (x, y) batches (tfdataset.main checks, tfdataset.py:1442-1473):
    NaN/Inf, range violations, max==min windows; accumulates label counts."""
    res = PipelineCheckResult()
    lo, hi = value_range
    for bi, (x, y) in enumerate(batches):
        x = np.asarray(x)
        y = np.asarray(y)
        for i in range(x.shape[0]):
            res.checked += 1
            xi = x[i]
            if not np.isfinite(xi).all():
                res.nan_count += 1
                log.error("NaN/Inf at batch %s item %s", bi, i)
            if xi.max() == xi.min():
                res.constant += 1
                log.error("constant sample at batch %s item %s", bi, i)
            if xi.min() < lo - 1e-5 or xi.max() > hi + 1e-5:
                res.out_of_range += 1
        for li in np.argwhere(y > 0.5)[:, 1] if y.ndim > 1 else []:
            name = labels[int(li)] if int(li) < len(labels) else str(li)
            res.label_counts[name] = res.label_counts.get(name, 0) + 1
        if max_batches is not None and bi + 1 >= max_batches:
            break
    log.info(
        "checked %s samples: %s nan, %s constant, %s out-of-range; labels %s",
        res.checked, res.nan_count, res.constant, res.out_of_range,
        res.label_counts,
    )
    return res


def debug_labels(label_space) -> dict:
    """Label mapping coverage report (tfdataset.debug_labels,
    tfdataset.py:1324-1342)."""
    out = {}
    for i, src in enumerate(label_space.source_labels):
        tgt = int(label_space.remap[i])
        extra = int(label_space.extra[i])
        out[src] = {
            "target": label_space.labels[tgt] if tgt >= 0 else None,
            "extra": label_space.labels[extra] if extra >= 0 else None,
        }
        log.info("%s -> %s (extra %s)", src, out[src]["target"],
                 out[src]["extra"])
    return out
