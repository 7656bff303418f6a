"""Batch classification by one client in a closed loop: each request is
pool batch ``i`` (in turn), normalized by the program's
``ops/features.py::normalize_rows`` where the traffic's ``front`` says so,
through ``infer/fused.py::make_fused_infer_fn`` with the workload's
``entry`` arguments; its logits are copied to the host before the next
request is sent.  A request's latency runs from the client's first call
to its logits on the host.

After the window every answer is compared with the reference's logits of
its pool batch (featurizer and model in float32 or better, without TF32).
"""

from __future__ import annotations

import itertools
import time

import torch
from torch.profiler import record_function

from portbench import compare, window
from portbench.cell import (
    Cell,
    Inputs,
    featurizer_config,
    free_program,
    make_inputs,
    program_model,
)
from portbench.reference import model as reference_model
from portbench.reference.featurizer import MelReference, image
from portbench.reference.layers import Ctx, exact
from portbench.traffic import slot
from portbench.weights import exact_float32

REFERENCE_ROWS = 64  # clips a block through the reference model


class Program:
    def __init__(self, cell: Cell, inputs: Inputs):
        from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
        from audio_training_tpu_torch.ops.features import normalize_rows

        entry = dict(cell.traffic["entry"])
        entry["out_dtype"] = getattr(torch, entry["out_dtype"])
        self.cell, self.inputs = cell, inputs
        self.infer = cell.hooks.get("wrap_infer", lambda f: f)(
            make_fused_infer_fn(program_model(cell, inputs.tensors),
                                featurizer_config(cell), device=cell.device,
                                **entry))
        self.normalize = (normalize_rows if cell.front.get("normalize_rows")
                          else None)
        self.index = itertools.count()
        self.answers, self.latencies = [], []

    def unit(self) -> None:
        k = slot(next(self.index), self.cell.traffic["pool"])
        raw, _ = self.inputs.batch(self.cell, k)
        t0 = time.perf_counter()
        with record_function("portbench.request"):
            if self.normalize is not None:
                with record_function("portbench.preprocess"):
                    raw = self.normalize(raw)
            logits = self.infer(raw).cpu()
        self.latencies.append(time.perf_counter() - t0)
        self.answers.append((k, logits))


@torch.no_grad()
def reference(cell: Cell, inputs: Inputs, batches, q=exact) -> dict:
    """Pool batch -> the reference's float32 logits on the host."""
    cfg = cell.config
    ref = reference_model(cfg["reference"])
    mel = MelReference(cell.geometry, cell.device)
    out = {}
    with exact_float32():
        for k in sorted(batches):
            clips, _ = inputs.batch(cell, k)
            img = image(clips, mel, cell.front)
            out[k] = torch.cat([ref.forward(Ctx(q=q), inputs.tensors, rows)
                                for rows in img.split(REFERENCE_ROWS)]).cpu()
    return out


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, -(-len(ordered) * q // 100) - 1)]


def run(cell: Cell) -> dict:
    from audio_training_tpu_torch.ops.cuda.fused_featurizer import (
        launch_counts,
    )

    import audio_training_tpu_torch.infer.fused  # noqa: F401

    cell.mark("imports")
    inputs = make_inputs(cell)
    cell.mark("weights and pool")
    program = Program(cell, inputs)
    cell.mark("program built")
    for _ in range(cell.traffic["warmup_requests"]):
        program.unit()
    program.answers.clear()
    program.latencies.clear()
    traced = None
    if cell.trace:
        traced = {"units": cell.traffic["trace_units"], "kind": "serve",
                  "context": {"cell": cell}, "counter": launch_counts}
    peak = compare.memory_peak(cell.device, reset=True)
    w = window.run(program.unit, cell.seconds, cell.device, 1, traced)
    window_peak = compare.memory_peak(cell.device)
    answers, latencies = program.answers, program.latencies
    del program
    free_program()
    started = window.boot_clock()
    ref = reference(cell, inputs, {k for k, _ in answers})
    reference_s = window.boot_clock() - started
    checks = compare.with_limits(compare.serving_numbers(answers, ref),
                                 cell.workload["limits"])
    audio_s = cell.geometry["clip_seconds"] * cell.batch * len(answers)
    return {
        "attempted": len(answers), "failed": 0, "window": w,
        "end_to_end": {
            "serve_audio_s_per_s": audio_s / w.seconds,
            "serve_request_ms_p95": percentile(latencies, 95) * 1e3,
        },
        "memory_peak_bytes": max(peak, window_peak),
        "window_peak_bytes": window_peak, "checks": checks,
        "reference_s": reference_s,
    }
