"""Batch classification as ``loops/serve.py`` runs it (the same client,
program, window and reference), with every answer also held clip by clip.

``clip_gap_ratio``: the largest, over the clips of every answer, of the
distance from a clip's logits to the reference's logits of that clip over
their distance to the nearest other clip's reference logits in the same
request.  Under 1, each clip's answer lies nearer its own clip than any
other; an answer copied from another clip's reads the inverse of that
clip's own ratio, above 1 however alike the two clips are.  It catches
the one copied answer that the gaps over the logits' spread miss where,
over a batch of 512, the worst clip's round-off reaches the gap between
two clips.
"""

from __future__ import annotations

import math

import torch

from portbench import compare, window
from portbench.cell import Cell, free_program, make_inputs
from portbench.loops.serve import Program, percentile, reference


def clip_gap_ratio(answers: list, ref: dict) -> float:
    """``answers``: (pool batch, logits on the host) of each request;
    ``ref``: pool batch -> the reference's float32 logits on the host."""
    worst = 0.0
    for k, logits in answers:
        want = ref[k].double()
        if logits is None or logits.shape != want.shape:
            return math.inf
        d = torch.cdist(logits.double(), want)
        own = d.diagonal().clone()
        d.fill_diagonal_(math.inf)
        worst = max(worst, (own / d.min(1).values).max().item())
    return worst


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
    numbers = {**compare.serving_numbers(answers, ref),
               "clip_gap_ratio": clip_gap_ratio(answers, ref)}
    audio_s = cell.geometry["clip_seconds"] * cell.batch * len(answers)
    return {
        "attempted": len(answers), "failed": 0, "window": w,
        "end_to_end": {
            "serve_audio_s_per_s": audio_s / w.seconds,
            "serve_request_ms_p95": percentile(latencies, 95) * 1e3,
        },
        "memory_peak_bytes": max(peak, window_peak),
        "window_peak_bytes": window_peak,
        "checks": compare.with_limits(numbers, cell.workload["limits"]),
        "reference_s": reference_s,
    }
