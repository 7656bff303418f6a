"""Readers that ``readers.py`` lacks, for the backbone's serving cell: a
span's device time less what was launched inside another span (the
squeeze-excite's 1x1 convolutions and SiLU nest in ``cnn.se``), and K1's
PCEN kernel alone."""

from __future__ import annotations

from portbench.counts import k1
from portbench.trace import TraceView

PCEN = "pcen_kernel"
PCEN_COUNTER = "fused_featurizer_pcen"


def span_less(view: TraceView, kind: str, span: str,
              less: str) -> float | None:
    """Device ms a unit launched inside ``span`` and outside ``less``."""
    if view.kind != kind:
        return None
    inner = {id(o) for o in view.launched_in(less)}
    ops = [o for o in view.launched_in(span) if id(o) not in inner]
    return view.ms_per_unit(ops) if ops else None


def pcen_ops(view: TraceView, kind: str) -> list | None:
    """The PCEN kernel's operations, where the trace holds as many as the
    program's launch counter counted over the same units."""
    if view.kind != kind:
        return None
    ops = [o for o in view.ops if k1.kernel_of(o.name) == PCEN]
    counted = view.context.get("launches", {}).get(PCEN_COUNTER)
    return ops if ops and len(ops) == counted else None


def pcen_ms(view: TraceView, kind: str) -> float | None:
    ops = pcen_ops(view, kind)
    return view.ms_per_unit(ops) if ops else None


def pcen_roofline(view: TraceView, kind: str) -> float | None:
    """Percent: the PCEN launches' least time (``counts/k1.py``) over their
    measured time."""
    ops = pcen_ops(view, kind)
    if not ops:
        return None
    cell = view.context["cell"]
    bound = len(ops) * k1.bound_s(PCEN, cell.batch, cell.geometry,
                                  cell.workload["k1"])
    return 100.0 * bound / (sum(o.end - o.start for o in ops) * 1e-6)
