"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
applies one of these to the traced window of its kind of cell ("train"
or "serve") and returns None where it finds nothing to read.

Device operations are assigned to layers by the profiler's kernel names
(K1's kernels) and by the host span that launched them: the benchmark's
``portbench.preprocess`` marker, PyTorch's ``Optimizer.step#Adam.step``.
The CNN is every other device operation of the units.
"""

from __future__ import annotations

from portbench.counts import cnn, k1, peaks
from portbench.trace import TraceView

PREPROCESS = "portbench.preprocess"
OPTIMIZER = "Optimizer.step#Adam.step"


def _cell(view: TraceView):
    return view.context["cell"]


def _linked(view: TraceView) -> bool:
    """Whether the trace tied device operations to their launches."""
    return any(o.launch is not None for o in view.ops)


def k1_ops(view: TraceView) -> list:
    return [o for o in view.ops if k1.kernel_of(o.name)]


def _k1_confirmed(view: TraceView) -> list | None:
    """K1's operations, where the trace holds as many mel kernels as the
    program's launch counters counted over the same units."""
    ops = k1_ops(view)
    mel = [o for o in ops if k1.kernel_of(o.name) in k1.MEL_KERNELS]
    counted = sum(v for n, v in view.context.get("launches", {}).items()
                  if n.startswith("fused_featurizer_mel"))
    return ops if mel and len(mel) == counted else None


def k1_ms(view: TraceView, kind: str) -> float | None:
    ops = _k1_confirmed(view) if view.kind == kind else None
    return view.ms_per_unit(ops) if ops else None


def k1_roofline(view: TraceView, kind: str) -> float | None:
    """Percent: the K1 launches' least time (``counts/k1.py``) over their
    measured time."""
    ops = _k1_confirmed(view) if view.kind == kind else None
    if not ops:
        return None
    cell = _cell(view)
    bound = sum(k1.bound_s(k1.kernel_of(o.name), cell.batch, cell.geometry,
                           cell.workload["k1"]) for o in ops)
    return 100.0 * bound / (sum(o.end - o.start for o in ops) * 1e-6)


def span_ms(view: TraceView, kind: str, span: str) -> float | None:
    if view.kind != kind or not _linked(view):
        return None
    ops = view.launched_in(span)
    return view.ms_per_unit(ops) if ops else None


def cnn_ms(view: TraceView, kind: str) -> float | None:
    if view.kind != kind or not _linked(view):
        return None
    other = {id(o) for o in (*k1_ops(view), *view.launched_in(PREPROCESS),
                             *view.launched_in(OPTIMIZER))}
    ops = [o for o in view.ops if id(o) not in other]
    return view.ms_per_unit(ops) if ops else None


def idle_share(view: TraceView, kind: str) -> float | None:
    """Percent of the traced window in which no device operation ran."""
    if view.kind != kind or not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)


def peak_mem_gb(view: TraceView, kind: str) -> float | None:
    peak = view.context.get("window_peak_bytes")
    return peak / 1e9 if view.kind == kind and peak else None


def mfu(view: TraceView, kind: str) -> float | None:
    """Percent of the bf16 dense peak: the counted operations of the traced
    units (the reference CNN's, forward and backward for training, and
    K1's) over the traced window."""
    if view.kind != kind or not view.ops:
        return None
    cell = _cell(view)
    per_clip = (cnn.flops_per_clip(cell.config,
                                   cell.traffic["front"].get("channels", 1),
                                   train=kind == "train")
                + k1.ops_per_clip(cell.geometry, cell.workload["k1"]))
    return (100.0 * per_clip * cell.batch * view.units / view.window_s
            / peaks.PEAK_BF16_FLOPS)
