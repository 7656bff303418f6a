"""The measured window, shared by the loops: units (steps or requests)
run back to back for ``seconds`` by the host clock, at most ``inflight``
of them queued on the card, and the window closes on a synchronize after
the last unit.  A traced run records ``trace_units`` units a third of the
way in (``trace.record``); they count as work of the window like any
other."""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import torch

from portbench import trace


def boot_clock() -> float:
    """Seconds since the machine booted, the clock of a process's start."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on :func:`boot_clock`."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    units: int
    seconds: float  # from the first unit's dispatch to the closing sync
    started: float  # boot_clock() at the first unit
    view: trace.TraceView | None


def run(unit: Callable[[], None], seconds: float, device: torch.device,
        inflight: int, traced: dict | None) -> Window:
    """``traced``: None, or the ``trace.record`` arguments ``units``,
    ``kind``, ``context`` and ``counter``."""
    sync(device)
    queued: deque = deque()
    view, done = None, 0
    started, t0 = boot_clock(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if traced and view is None and time.perf_counter() - t0 > seconds / 3:
            view = trace.record(unit, **traced)
            done += traced["units"] + 1
            continue
        unit()
        done += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > inflight:
                queued.popleft().synchronize()
    sync(device)
    return Window(done, time.perf_counter() - t0, started, view)
