"""Weights made from the seed on the device, in one draw, and BatchNorm
running statistics set from the reference's batch moments.

Every kernel and dense matrix takes uniform values of variance ``1 /
fan_in`` (LeCun's scale), biases and BatchNorm shifts 0, BatchNorm scales 1,
constants as the reference's ``spec`` names them.  One ``torch.rand`` call
on a generator on the device draws all of it, in float32.  The same tensors
load into the program (``load_state_dict``, which checks every name and
shape) and feed the reference, so neither side takes its weights from the
other.

Running statistics of 0 and 1 leave a random network's logits all but
independent of its input (the EfficientNet's ``x / 255`` makes its image a
constant plus a 0.4% ripple).  ``calibrate`` sets each BatchNorm's
running mean and variance to the batch moments that the reference reads
at its input on a few clips of the pool, as training would leave them, so
that eval-mode logits depend on the clip.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.layers import Ctx


def make(spec: list, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [(n, s) for n, s, init in spec if init == "fan_in"]
    flat = torch.rand(sum(math.prod(s) for _, s in drawn), generator=gen,
                      device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, init in spec:
        if init == "fan_in":
            size, fan_in = math.prod(shape), math.prod(shape[1:])
            out[name] = (flat[at:at + size].view(shape)
                         * math.sqrt(3.0 / fan_in))
            at += size
        elif init in ("zeros", "stat_mean"):
            out[name] = torch.zeros(shape, device=device)
        elif init in ("ones", "stat_var"):
            out[name] = torch.ones(shape, device=device)
        elif init.startswith("const:"):
            out[name] = torch.full(shape, float(init[6:]), device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


@torch.no_grad()
def calibrate(ref, tensors: dict, image: torch.Tensor) -> None:
    """Set every ``*.running_mean`` / ``*.running_var`` in ``tensors`` to
    the batch moments of ``image`` (NCHW float32) at that BatchNorm's input
    in the reference, in float32 without TF32."""
    moments = {}
    with exact_float32():
        ref.forward(Ctx(moments=moments), tensors, image)
    for name, (mean, var) in moments.items():
        tensors[f"{name}.running_mean"].copy_(mean)
        tensors[f"{name}.running_var"].copy_(var)


class exact_float32:
    """TF32 off for matmuls and cuDNN within the block, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
