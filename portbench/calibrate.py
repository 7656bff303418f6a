"""The readings that the limits in ``workloads/<cell>.json`` are set from,
for many seeds in one process (the benchmark's own runs never run this):

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--side program|control|fault] [--fault <name>] [--dtype float32]
        [--image-dtype float32] [--dump readings.json]

``program``: the cell's numbers as a run computes them, after a short
window.  ``control``: the reference in the control's precision
(``reference/quant.py``) put in the program's place, against the
reference.  ``fault``: the program with one fault planted in the timed
path (:data:`FAULTS`).  ``--dtype`` runs the program's model in another
compute dtype, ``--image-dtype`` has the featurizer hand it another
dtype, as second witnesses; ``--dump`` writes each seed's readings (by
leaf, for training).  One JSON line a seed, then the
largest and the smallest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import compare
from portbench.cell import load_cell, make_inputs
from portbench.reference.quant import fp8


def _half_batch_step(step):
    def faulty(state, metrics, mel, y, generator=None):
        half = mel.shape[0] // 2
        return step(state, metrics, mel[:half], y[:half], generator)
    return faulty


def _unchanged_step(step):
    def faulty(state, metrics, mel, y, generator=None):
        return state, metrics
    return faulty


def _swapped_answer(infer):
    def faulty(raw):
        out = infer(raw).clone()
        out[0] = out[1]
        return out
    return faulty


def _half_batch_infer(infer):
    def faulty(raw):
        half = infer(raw[: raw.shape[0] // 2])
        return torch.cat([half, half])
    return faulty


FAULTS = {
    "half_batch_step": {"wrap_step": _half_batch_step},
    "unchanged_step": {"wrap_step": _unchanged_step},
    "swapped_answer": {"wrap_infer": _swapped_answer},
    "half_batch_answers": {"wrap_infer": _half_batch_infer},
}


def control_numbers(cell) -> tuple[dict, dict | None]:
    """The control's numbers: the reference in fp8 against the reference."""
    inputs = make_inputs(cell)
    loop = cell.loop()
    if cell.traffic["loop"] == "train":
        lowered, exact = (loop.reference(cell, inputs, q=fp8),
                          loop.reference(cell, inputs))
        return (compare.training_numbers(lowered, exact),
                {"program": lowered, "reference": exact})
    batches = range(cell.traffic["pool"])
    lowered = loop.reference(cell, inputs, batches, q=fp8)
    return compare.serving_numbers(list(lowered.items()), loop.reference(
        cell, inputs, batches)), None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--side", choices=("program", "control", "fault"),
                   default="program")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--dtype")
    p.add_argument("--image-dtype")
    p.add_argument("--dump")
    args = p.parse_args(argv)
    dump = []
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = load_cell(args.workload, seed, args.seconds, False, "cuda")
        if args.dtype:
            cell.config["model"]["dtype"] = args.dtype
        if args.image_dtype:
            cell.traffic["entry"]["out_dtype"] = args.image_dtype
        if args.side == "control":
            numbers, detail = control_numbers(cell)
        else:
            if args.side == "fault":
                cell.hooks = FAULTS[args.fault]
            out = cell.loop().run(cell)
            numbers = {n: v for n, v, _ in out["checks"]}
            detail = out.get("detail")
        readings.append(numbers)
        if detail:  # logits are tensors: keep their gap only
            detail = {side: {k: v for k, v in d.items() if k != "logits"}
                      for side, d in detail.items()}
        dump.append({"seed": seed, "numbers": numbers, "detail": detail})
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "fault": args.fault, "dtype": args.dtype,
                          "seed": seed, "numbers": numbers}), flush=True)
    summary = {n: {"max": max(r[n] for r in readings),
                   "min": min(r[n] for r in readings)} for n in readings[0]}
    print(json.dumps({"workload": args.workload, "side": args.side,
                      "fault": args.fault, "dtype": args.dtype,
                      "seeds": len(readings), "summary": summary}), flush=True)
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(dump, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
