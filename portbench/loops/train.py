"""Closed-loop training, the program's ``fit`` inner loop: each step takes
pool batch ``i`` and its mixup partner ``i + 1`` through
``data/preprocess.py::make_preprocess_fn(augment=True)`` and
``train/step.py::make_train_step()`` on one ``train/state.py`` state, the
mixup and dropout draws from two generators on the card, as ``fit``
composes them (``train/loop.py:231-249``).  Steps are dispatched back to
back, at most ``inflight`` queued.

Set-up drives the state through the first three steps, reads the first
step's logits (a forward hook on the model, removed after it) and loss,
the first gradient (Adam's first moment after one step, over 1 - b1) and
the parameters' change after the three, and hands the same state to the
window.  After the window the reference runs the three steps from
the same weights, pool, draws and seeds, and the two are compared
(``portbench/compare.py``).
"""

from __future__ import annotations

import itertools

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
from portbench.reference import split
from portbench.reference.featurizer import MelReference, image
from portbench.reference.layers import Ctx, exact
from portbench.reference.train import Adam, loss_and_grads, mix
from portbench.traffic import slot
from portbench.weights import exact_float32

CHECKED_STEPS = 3
B1 = 0.9  # Adam's first-moment decay, as the program's optimizer sets it


class Program:
    """The program's training objects and one step of it (``unit``)."""

    def __init__(self, cell: Cell, inputs: Inputs):
        from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
        from audio_training_tpu_torch.train.state import create_train_state
        from audio_training_tpu_torch.train.step import (
            fresh_metrics,
            make_train_step,
        )

        t, dev = cell.config["training"], cell.device
        self.cell, self.inputs = cell, inputs
        self.state = create_train_state(program_model(cell, inputs.tensors),
                                        t["learning_rate"])
        self.preprocess = make_preprocess_fn(
            featurizer_config(cell), augment=True,
            mixup_alpha=t["mixup_alpha"], mixup_chance=t["mixup_chance"],
            channels=cell.front["channels"], device=dev)
        self.step = cell.hooks.get("wrap_step", lambda s: s)(make_train_step())
        self.metrics = fresh_metrics(dev)
        self.gen_pre = torch.Generator(device=dev).manual_seed(
            cell.sub_seed("mixup"))
        self.gen_drop = torch.Generator(device=dev).manual_seed(
            cell.sub_seed("dropout"))
        self.index = itertools.count()

    def unit(self) -> None:
        i, pool = next(self.index), self.cell.traffic["pool"]
        one, y_one = self.inputs.batch(self.cell, slot(i, pool))
        two, y_two = self.inputs.batch(self.cell, slot(i + 1, pool))
        with record_function("portbench.preprocess"):
            mel, y = self.preprocess(one, y_one, two, y_two, self.gen_pre)
        with record_function("portbench.step"):
            self.state, self.metrics = self.step(
                self.state, self.metrics, mel, y, self.gen_drop)

    def named(self) -> dict:
        return dict(self.state.model.named_parameters())

    def checked_steps(self) -> dict:
        """The first steps and what they read: the first step's logits, loss
        a step, the first gradient's norm and the change's norm after the
        last, by leaf."""
        losses, grads, logits = [], {}, []
        batch = self.cell.batch
        hook = self.state.model.register_forward_hook(
            lambda module, args, out: logits.append(out.detach().float()))
        for k in range(CHECKED_STEPS):
            before = self.metrics["loss_sum"].clone()
            self.unit()
            hook.remove()
            with torch.no_grad():
                losses.append(
                    ((self.metrics["loss_sum"] - before) / batch).item())
                if k == 0:
                    opt = self.state.optimizer
                    grads = {n: (opt.state[p]["exp_avg"] / (1.0 - B1)
                                 ).norm().item()
                             for n, p in self.named().items()
                             if p in opt.state}
        with torch.no_grad():
            change = {n: (p - self.inputs.tensors[n]).norm().item()
                      for n, p in self.named().items()}
        return {"logits": logits[0].cpu() if logits else None,
                "loss": losses, "grad": grads, "change": change}


def reference(cell: Cell, inputs: Inputs, q=exact) -> dict:
    """The reference's first steps from the benchmark's weights, in
    float32 without TF32 (``q`` rounds the products' operands: the
    control), read as :meth:`Program.checked_steps` reads the program's."""
    cfg, t, dev = cell.config, cell.config["training"], cell.device
    pool = cell.traffic["pool"]
    ref = reference_model(cfg["reference"])
    spec = ref.spec(cfg["num_labels"], cell.geometry, cell.front["channels"])
    params, stats = split(spec, {k: v.clone() for k, v in
                                 inputs.tensors.items()})
    mel = MelReference(cell.geometry, dev)
    gen_pre = torch.Generator(device=dev).manual_seed(cell.sub_seed("mixup"))
    gen_drop = torch.Generator(device=dev).manual_seed(
        cell.sub_seed("dropout"))
    adam = Adam(params, t["learning_rate"])
    losses, grads, first = [], {}, None
    with exact_float32():
        for k in range(CHECKED_STEPS):
            one, y_one = inputs.batch(cell, slot(k, pool))
            two, y_two = inputs.batch(cell, slot(k + 1, pool))
            x, y = mix(gen_pre, one, y_one, two, y_two, t["mixup_alpha"],
                       t["mixup_chance"])
            ctx = Ctx(train=True, generator=gen_drop, q=q,
                      dropout=cfg["model"]["kwargs"].get("dropout", 0.5))
            logits, loss, g = loss_and_grads(ref.forward, ctx, params, stats,
                                             image(x, mel, cell.front), y)
            losses.append(loss.item())
            if k == 0:
                first = logits.cpu()
                grads = {n: v.norm().item() for n, v in g.items()}
            adam.step(g)
            del g
    change = {n: (params[n] - inputs.tensors[n]).norm().item() for n in params}
    return {"logits": first, "loss": losses, "grad": grads, "change": change}


def run(cell: Cell) -> dict:
    from audio_training_tpu_torch.ops.cuda.fused_featurizer import (
        launch_counts,
    )

    import audio_training_tpu_torch.data.preprocess  # noqa: F401
    import audio_training_tpu_torch.train.step  # noqa: F401

    cell.mark("imports")
    inputs = make_inputs(cell)
    cell.mark("weights and pool")
    program = Program(cell, inputs)
    cell.mark("program built")
    readings = program.checked_steps()
    cell.mark("checked steps")
    for _ in range(cell.traffic["warmup_steps"]):
        program.unit()
    traced = None
    if cell.trace:
        traced = {"units": cell.traffic["trace_units"], "kind": "train",
                  "context": {"cell": cell}, "counter": launch_counts}
    peak = compare.memory_peak(cell.device, reset=True)
    w = window.run(program.unit, cell.seconds, cell.device,
                   cell.traffic["inflight"], traced)
    window_peak = compare.memory_peak(cell.device)
    del program
    free_program()
    started = window.boot_clock()
    ref = reference(cell, inputs)
    reference_s = window.boot_clock() - started
    checks = compare.with_limits(compare.training_numbers(readings, ref),
                                 cell.workload["limits"])
    return {
        "attempted": w.units, "failed": 0, "window": w,
        "end_to_end": {"train_samples_per_s": w.units * cell.batch / w.seconds},
        "memory_peak_bytes": max(peak, window_peak),
        "window_peak_bytes": window_peak, "checks": checks,
        "reference_s": reference_s,
        "detail": {"program": readings, "reference": ref},
    }
