"""A serving cell's gaps to the reference with the program's precision put
back one piece at a time, for many seeds in one process (the benchmark's
own runs never run this):

    python3 -m portbench.ladder --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--rungs float32,float32_tf32,default_tier,bf16_image,program]

Each rung runs the cell's serving loop as a run does (a short window, then
every answer against the reference) with the program changed so:

* ``float32``: K1's exact tier (``"highest"``), a float32 image, the model
  in float32, TF32 off for cuDNN and matrix products;
* ``float32_tf32``: the same with TF32 as PyTorch leaves it;
* ``default_tier``: ``float32`` on the cell's own K1 tier;
* ``bf16_image``: that, with the cell's own image dtype;
* ``program``: the cell as it is (its tier, image and model dtype, TF32 as
  PyTorch leaves it).

One JSON line a seed and rung, then the largest and the smallest reading
of each number by rung.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.cell import load_cell

RUNGS = {
    # rung: (K1 tier or None for the cell's, image dtype or None,
    #        model dtype or None, TF32 off)
    "float32": ("highest", "float32", "float32", True),
    "float32_tf32": ("highest", "float32", "float32", False),
    "default_tier": (None, "float32", "float32", True),
    "bf16_image": (None, None, "float32", True),
    "program": (None, None, None, False),
}


def numbers(workload: str, seed: int, seconds: float, rung: str) -> dict:
    tier, image, model, exact = RUNGS[rung]
    cell = load_cell(workload, seed, seconds, False, "cuda")
    if tier:
        cell.traffic["entry"]["precision"] = tier
    if image:
        cell.traffic["entry"]["out_dtype"] = image
    if model:
        cell.config["model"]["dtype"] = model
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if exact:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        out = cell.loop().run(cell)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {n: v for n, v, _ in out["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rungs", default=",".join(RUNGS))
    args = p.parse_args(argv)
    rungs = args.rungs.split(",")
    readings: dict[str, list] = {r: [] for r in rungs}
    for seed in (int(s) for s in args.seeds.split(",")):
        for rung in rungs:
            got = numbers(args.workload, seed, args.seconds, rung)
            readings[rung].append(got)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "rung": rung, "numbers": got}), flush=True)
    for rung, rs in readings.items():
        print(json.dumps({"workload": args.workload, "rung": rung,
                          "seeds": len(rs), "summary": {
                              n: {"max": max(r[n] for r in rs),
                                  "min": min(r[n] for r in rs)}
                              for n in rs[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
