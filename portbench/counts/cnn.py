"""The CNN's operations a clip, counted by ``torch.utils.flop_counter``'s
``FlopCounterMode`` over the reference model (``portbench/reference/``)
at the cell's input shape, on meta tensors: the forward for serving, the
forward and the backward for training (no gradient of the input image).
Convolutions and matrix products count 2 operations a multiply-add;
elementwise passes count nothing."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts.k1 import frames
from portbench.reference import model as reference_model
from portbench.reference.layers import Ctx
from portbench.reference.train import bce


@functools.cache
def _count(reference: str, num_labels: int, n_mels: int, n_frames: int,
           channels: int, train: bool) -> int:
    ref = reference_model(reference)
    spec = ref.spec(num_labels, {"n_mels": n_mels}, channels)
    tensors = {n: torch.empty(s, device="meta", requires_grad=train
                              and init not in ("stat_mean", "stat_var"))
               for n, s, init in spec}
    x = torch.empty((1, channels, n_mels, n_frames), device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = ref.forward(Ctx(train=train), tensors, x)
        if train:
            bce(logits, torch.zeros_like(logits)).backward()
    return counter.get_total_flops()


def flops_per_clip(config: dict, channels: int, train: bool) -> int:
    g = config["geometry"]
    return _count(config["reference"], config["num_labels"], g["n_mels"],
                  frames(g), channels, train)
