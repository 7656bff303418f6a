"""Tracing and profiling (port of ``audio_training_tpu/utils/profiling.py``;
the reference's optional TensorBoard profiler window and memory estimator,
audiomodel.py:940-946, 2720-2767).

Each helper keeps its JAX counterpart's claim on the card:

* :func:`trace` records ``torch.profiler`` CPU and CUDA activity for the
  enclosed block and writes a Chrome trace under ``log_dir``;
* :func:`time_fn` times a call, synchronizing CUDA where its output lies on
  the card;
* :func:`device_event_summary` totals the card's kernel time by kernel
  name from the newest trace, and :func:`unrecorded_launches` lists the
  launches the trace left out;
* :func:`fusion_layer_map` maps each kernel to the ``nn.Module`` paths it
  ran under (JAX parses the module path from the compiled HLO's op
  metadata; here forward hooks push a ``record_function`` range for every
  module, and the trace links each kernel to the launch inside them);
* :func:`state_memory_bytes` and :func:`log_memory_stats` count a train
  state's tensors and read the card's allocator.

The program's own spans and counters live here too:

* :func:`span` is a ``record_function`` range while a ``torch.profiler``
  records and a shared null context otherwise, so the program's spans sit
  in the profiler's trace beside the card's activity, and cost one check
  when nothing records;
* :func:`region` records a layer's forward as a span and its backward as
  ``<name>.backward``, from the gradient reaching the layer's output to
  its leaving the layer's inputs (inserted only while a profiler records);
* :func:`setup_span` times a one-off set-up call on ``CLOCK_BOOTTIME``
  whether a profiler records or not, read back by :func:`setup_spans`;
* the counter registry (:func:`register_counters`, :func:`count`,
  :func:`counts`, :func:`reset_counts`) holds the kernels' launch counts,
  one group a module (``fused_featurizer``, ``melspec``,
  ``probe_megakernel``, ``batch_norm``; ``efficientnet`` counts the
  EfficientNets' blocks by kind and their squeeze-excite gates).

``MODULE_RANGE``'s forward hooks are :func:`fusion_layer_map`'s offline
tool and push no range otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import tempfile
import time
import warnings
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.autograd.profiler import record_function

log = logging.getLogger(__name__)

MODULE_RANGE = "module::"  # prefix of the ranges fusion_layer_map pushes
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_PRE_ROLL = 128  # fills in trace's warm-up step, past the kernels it loses
_SETUP_KEPT = 1024  # set-up spans kept, the newest
_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_setup: collections.deque = collections.deque(maxlen=_SETUP_KEPT)
_counters: dict[str, dict[str, int]] = {}


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared null context: one check of the profiler's state."""
    return record_function(name) if _recording() else _NULL


def _close(ranges: list) -> None:
    while ranges:
        ranges.pop().__exit__(None, None, None)


class _Out(torch.autograd.Function):
    """The identity at a region's output; its backward opens the region's
    backward range (and queues its closing at the end of the backward
    pass, should the gradient never leave the region's inputs)."""

    @staticmethod
    def forward(ctx, ranges, name, x):
        ctx.ranges, ctx.name = ranges, name
        return x.detach()

    @staticmethod
    def backward(ctx, g):
        rf = record_function(ctx.name)
        rf.__enter__()
        ctx.ranges.append(rf)
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: _close(ctx.ranges))
        return None, None, g


class _In(torch.autograd.Function):
    """The identity at a region's inputs (the tensors that need a
    gradient, its parameters among them); its backward, run once every one
    of their gradients is computed, closes the region's backward range."""

    @staticmethod
    def forward(ctx, ranges, *xs):
        ctx.ranges = ranges
        return tuple(x.detach() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _close(ctx.ranges)
        return (None, *grads)


def region(name: str, fn: Callable[..., torch.Tensor], *xs):
    """``fn(*xs)`` (one tensor out), recorded while a profiler records as
    the span ``name`` and, where it needs a gradient, its backward as the
    span ``name + ".backward"``.  Pass every tensor ``fn`` differentiates,
    the layer's parameters too: the backward range closes when the last
    of their gradients leaves the region.  Otherwise ``fn(*xs)`` with the
    autograd graph it has alone.  The identities at the boundary return
    detached aliases that share their input's version counter, so an
    in-place change of the output is checked as it is without them."""
    if not _recording():
        return fn(*xs)
    grads = torch.is_grad_enabled() and [
        i for i, x in enumerate(xs)
        if isinstance(x, torch.Tensor) and x.requires_grad]
    ranges: list = []
    if grads:
        xs = list(xs)
        for i, x in zip(grads, _In.apply(ranges, *(xs[i] for i in grads))):
            xs[i] = x
    with record_function(name):
        out = fn(*xs)
    if grads and out.requires_grad:
        out = _Out.apply(ranges, name + ".backward", out)
    return out


@contextlib.contextmanager
def setup_span(name: str):
    """Time the enclosed one-off set-up (also as a decorator) on
    ``CLOCK_BOOTTIME``, whether a profiler records or not; the newest
    ``_SETUP_KEPT`` are kept for :func:`setup_spans`."""
    start = time.clock_gettime(time.CLOCK_BOOTTIME)
    try:
        yield
    finally:
        _setup.append((name, start, time.clock_gettime(time.CLOCK_BOOTTIME)))


def setup_spans() -> list[tuple[str, float, float]]:
    """The set-up spans so far, as (name, start, end) in seconds on
    ``CLOCK_BOOTTIME``, in the order they ended."""
    return list(_setup)


def register_counters(group: str, names) -> None:
    """Counters ``names`` of ``group``, each at 0."""
    _counters[group] = dict.fromkeys(names, 0)


def count(group: str, name: str) -> None:
    _counters[group][name] += 1


def counts(group: str) -> dict[str, int]:
    """The counts of ``group`` since its last reset."""
    return dict(_counters[group])


def reset_counts(group: str) -> None:
    _counters[group] = dict.fromkeys(_counters[group], 0)


@contextlib.contextmanager
def trace(log_dir: str | Path = "./profile"):
    """Record CPU and (where there is a card) CUDA activity of the enclosed
    block; on exit the card is synchronized and the Chrome trace written to
    ``log_dir/<ns>.trace.json`` (replacing the Keras profile_batch=(10, 30)
    window).  Yields the ``torch.profiler.profile``.

    On the card the profiler can leave out the first few dozen kernels
    after it is enabled, so it is enabled one step early: ``_PRE_ROLL``
    one-element fills run in a warm-up step that is not recorded, and the
    recorded step is the block.  :func:`unrecorded_launches` lists what a
    trace still left out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    path = log_dir / f"{time.time_ns()}.trace.json"
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        if cuda:
            for _ in range(_PRE_ROLL):
                torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        prof.step()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    log.info("profile written to %s", path)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def _block_until_ready(out) -> None:
    for device in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> dict:
    """Timing harness: per-call host wall time in ms, each call's output
    waited for on the card where it lies there (JAX's
    ``block_until_ready``)."""
    for _ in range(warmup):
        out = fn(*args)
    _block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1000)
    arr = np.asarray(times)
    return {
        "mean_ms": float(arr.mean()),
        "min_ms": float(arr.min()),
        "p50_ms": float(np.median(arr)),
        "p90_ms": float(np.percentile(arr, 90)),
        "iters": iters,
    }


def _newest_trace(trace_dir: str | Path) -> list[dict]:
    paths = sorted(Path(trace_dir).glob("*.trace.json"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return json.loads(paths[-1].read_text())["traceEvents"]


def _unrecorded(events: list[dict]) -> list[tuple[int, str]]:
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in _DEVICE_CATS}
    launches = sorted((e for e in events if e.get("ph") == "X"
                       and e.get("cat") in _LAUNCH_CATS
                       and "Launch" in e["name"]),
                      key=lambda e: e["ts"])
    return [(i, e["name"]) for i, e in enumerate(launches)
            if e.get("args", {}).get("correlation") not in recorded]


def unrecorded_launches(trace_dir: str | Path) -> list[tuple[int, str]]:
    """The kernel launches of the newest trace under ``trace_dir`` that the
    trace holds no device event for, as ``(position among the trace's
    launches in time order, launch call)``.  Empty for a whole trace (and
    for one without a card)."""
    return _unrecorded(_newest_trace(trace_dir))


def device_event_summary(
    trace_dir: str | Path, device: int | str = 0,
) -> list[tuple[str, float]]:
    """Aggregate device-event durations from a :func:`trace` capture.

    Reads the newest trace under ``trace_dir`` and returns ``(event_name,
    total_ms)`` sorted by cost: for a card index, its kernels, copies and
    fills; for ``"cpu"``, the host's operator events (inclusive of the
    operators they call).  This is the measured per-kernel table; pair it
    with :func:`fusion_layer_map` to attribute kernels to layers.  A card's
    summary warns when the trace left out kernels that were launched
    (:func:`unrecorded_launches`): its totals are then short.
    """
    events = _newest_trace(trace_dir)
    agg: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if device == "cpu":
            keep = e.get("cat") == "cpu_op"
        else:
            keep = (e.get("cat") in _DEVICE_CATS
                    and e.get("args", {}).get("device") == device)
        if keep:
            agg[e["name"]] = agg.get(e["name"], 0.0) + e.get("dur", 0.0)
    if device != "cpu":
        lost = _unrecorded(events)
        if lost:
            warnings.warn(
                f"the trace under {trace_dir} holds no device event for "
                f"{len(lost)} launches (positions {[i for i, _ in lost]}): "
                f"the summary's totals are short", RuntimeWarning,
                stacklevel=2)
    return sorted(
        ((name, dur / 1000.0) for name, dur in agg.items()),
        key=lambda kv: -kv[1],
    )


def _push_module_ranges(model: torch.nn.Module) -> list:
    """Forward hooks that hold a ``record_function`` range named
    ``module::<root>.<path>`` open over each module's forward."""
    root = type(model).__name__
    open_ranges: list = []
    handles = []

    def pre(path):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(MODULE_RANGE + path)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for name, module in model.named_modules():
        path = f"{root}.{name}" if name else root
        handles.append(module.register_forward_pre_hook(pre(path)))
        handles.append(module.register_forward_hook(post, always_call=True))
    return handles


def kernel_module_map(trace_dir: str | Path) -> dict[str, list[str]]:
    """Each kernel of the newest trace under ``trace_dir`` -> the innermost
    module ranges (:func:`fusion_layer_map`'s) its launches ran under, in
    the order first seen.  A kernel is tied to its launch by the CUDA
    correlation id, and the launch to the ranges open on its thread at
    that time.  A trace with no kernel (no card) maps the host's operators
    instead.  Launches outside every module range are left out."""
    events = [e for e in _newest_trace(trace_dir) if e.get("ph") == "X"]
    ranges: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e["name"].startswith(MODULE_RANGE)):
            ranges.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0),
                 e["name"][len(MODULE_RANGE):]))

    def innermost(tid, ts):
        # the latest-starting open range, the shorter of two that start
        # together
        open_at = [(start, -end, path) for start, end, path
                   in ranges.get(tid, []) if start <= ts <= end]
        return max(open_at)[2] if open_at else None

    launches = {e["args"]["correlation"]: (e["tid"], e["ts"])
                for e in events if e.get("cat") in _LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    points = [(e["name"], launches.get(e.get("args", {}).get("correlation")))
              for e in events if e.get("cat") == "kernel"]
    if not points:
        points = [(e["name"], (e["tid"], e["ts"])) for e in events
                  if e.get("cat") == "cpu_op"]
    out: dict[str, list[str]] = {}
    for name, at in sorted((p for p in points if p[1]), key=lambda p: p[1][1]):
        path = innermost(*at)
        if path is not None and path not in out.get(name, []):
            out.setdefault(name, []).append(path)
    return out


def fusion_layer_map(fn, *args, model: torch.nn.Module,
                     trace_dir: str | Path | None = None
                     ) -> dict[str, list[str]]:
    """Map the kernels that ``fn(*args)`` launches to the ``model`` layers
    they ran under (JAX: fusion names to the Flax module path of the
    compiled HLO's op metadata): runs ``fn`` once inside :func:`trace`
    with a range pushed around each module's forward, and returns
    :func:`kernel_module_map` of that trace, e.g. ``{"<cudnn kernel>":
    ["BadWinner2.convs.4"]}``.  The trace goes to ``trace_dir`` (a
    temporary directory by default)."""
    handles = _push_module_ranges(model)
    try:
        with contextlib.ExitStack() as stack:
            if trace_dir is None:
                trace_dir = stack.enter_context(tempfile.TemporaryDirectory())
            with trace(trace_dir):
                fn(*args)
            return kernel_module_map(trace_dir)
    finally:
        for h in handles:
            h.remove()


def state_memory_bytes(state, batch_shape: tuple | None = None) -> dict:
    """Memory of a train state: parameters, the optimizer's state tensors
    (torch allocates Adam's moments at the first step) and the BatchNorm
    statistics (the model's buffers), the analogue of
    keras_model_memory_usage_in_bytes (audiomodel.py:2720-2767)."""
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    params = nbytes(state.model.parameters())
    opt = nbytes(t for s in state.optimizer.state.values()
                 for t in _tensors(s))
    bs = nbytes(state.model.buffers())
    out = {
        "params_bytes": params,
        "optimizer_bytes": opt,
        "batch_stats_bytes": bs,
        "total_bytes": params + opt + bs,
    }
    if batch_shape is not None:
        out["activation_estimate_bytes"] = int(np.prod(batch_shape)) * 4 * 8
    return out


def log_memory_stats() -> dict:
    """Live memory of each card from its caching allocator: bytes in use,
    the peak since the last ``reset_peak_memory_stats`` and the card's
    total.  Empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
        log.info("cuda:%s memory %s", i, stats[f"cuda:{i}"])
    return stats
