"""The traced part of a window: ``torch.profiler`` over a few steps or
requests, reduced to a :class:`TraceView` that the per-layer readers
(``portbench/metrics/``) read.

The profiler is enabled one step early, as ``utils/profiling.py:40-76``
(``trace``) does: on the card it can lose the first launches after it is
enabled, so a warm-up step of 128 one-element fills and one unit runs
unrecorded, the card is synchronized, and only then are the units
recorded.  Nothing is written to disk.

Spans come from the benchmark's own markers (``portbench.*`` ranges
around its calls into the program) and from PyTorch's
``Optimizer.step#Adam.step`` range.  A device operation belongs to a span
when the host call that launched it lies inside the span.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

UNIT = "portbench.unit"
PRE_ROLL = 128
ANNOTATIONS = ("portbench.", "ProfilerStep", "Optimizer.")


class Op(NamedTuple):
    """A device operation: name, start and end on the card (us), and the
    host time of its launch (us, None where the trace did not link it)."""
    name: str
    start: float
    end: float
    launch: float | None


class Span(NamedTuple):
    """A host range: name, start and end (us)."""
    name: str
    start: float
    end: float


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


@dataclass
class TraceView:
    """What a reader reads: the device operations and host spans of the
    recorded units, the window they span, and the cell's context."""
    ops: list[Op]
    spans: list[Span]
    units: int
    kind: str  # "train" or "serve"
    context: dict = field(default_factory=dict)

    @property
    def window(self) -> tuple[float, float]:
        marks = [s for s in self.spans if s.name == UNIT]
        start = min(s.start for s in marks)
        end = max([s.end for s in marks] + [o.end for o in self.ops])
        return start, end

    @property
    def window_s(self) -> float:
        s, e = self.window
        return (e - s) * 1e-6

    def busy_s(self) -> float:
        s, e = self.window
        return union_length((max(o.start, s), min(o.end, e))
                            for o in self.ops if o.end > s and o.start < e) * 1e-6

    def launched_in(self, name: str) -> list[Op]:
        """Operations launched inside any span called ``name``."""
        ranges = sorted((s.start, s.end) for s in self.spans if s.name == name)
        return [o for o in self.ops if o.launch is not None and any(
            a <= o.launch <= b for a, b in ranges)]

    def ms_per_unit(self, ops) -> float:
        return sum(o.end - o.start for o in ops) * 1e-3 / self.units

    def breakdown(self) -> dict:
        """The ten device operations that took most time, summed by name,
        and the ten longest idle gaps, each named by the innermost host span
        open where it starts; seconds."""
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        s, e = self.window
        idle = sorted(gaps([(o.start, o.end) for o in self.ops], s, e),
                      key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[self.host_at(a), (b - a) * 1e-6]
                              for a, b in idle]}

    def host_at(self, t: float) -> str:
        open_ = [s for s in self.spans if s.start <= t <= s.end]
        if not open_:
            return "no host span"
        return min(open_, key=lambda s: s.end - s.start).name


def view_of(events, units: int, kind: str, context: dict) -> TraceView:
    """A :class:`TraceView` from ``profile.events()`` (FunctionEvents)."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            host.append(e)
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(ANNOTATIONS)):
            # the card's copies of host ranges (gpu_user_annotation) are
            # not work on the card
            device.append(e)
    # a device operation carries the correlation id of the CUDA API call
    # that launched it (as ``id``; older releases as
    # ``linked_correlation_id``)
    launches = {e.id: e.time_range.start for e in host
                if e.name.startswith("cu")}
    ops = [Op(e.name, e.time_range.start, e.time_range.end, launches.get(
        getattr(e, "linked_correlation_id", None) or e.id)) for e in device]
    spans = [Span(e.name, e.time_range.start, e.time_range.end)
             for e in host]
    return TraceView(ops, spans, units, kind, context)


def record(run_unit: Callable[[], None], units: int, kind: str,
           context: dict, counter: Callable[[], dict] | None = None
           ) -> TraceView:
    """Profile ``units`` calls of ``run_unit`` (each inside a
    ``portbench.unit`` span), enabled one unit early.  ``counter`` reads
    the program's launch counters: their growth over the recorded units
    goes into the context as ``launches``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(PRE_ROLL):
            torch.zeros(1, device="cuda")
        run_unit()
        torch.cuda.synchronize()
        prof.step()
        before = counter() if counter else {}
        for _ in range(units):
            with record_function(UNIT):
                run_unit()
        torch.cuda.synchronize()
        after = counter() if counter else {}
        prof.step()
    context = {**context,
               "launches": {k: after[k] - before[k] for k in after}}
    return view_of(events, units, kind, context)
