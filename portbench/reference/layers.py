"""Plain layers of the reference models, on NCHW float32 tensors.

A model is a function of a dict of tensors, named as the program's
``state_dict`` names them, so that one set of weights made by the benchmark
loads into both.  Every convolution and dense product goes through ``q``,
the precision of the products: :func:`exact` for the reference, or the fp8
control (``reference/quant.py``).

``Ctx`` carries what differs between calls: train mode (BatchNorm on the
batch's moments, dropout on), the generator that draws the dropout masks,
and ``moments``, a dict that collects each BatchNorm's batch moments by
name (the benchmark sets running statistics from them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

BN_EPS = 1e-3  # Keras BatchNormalization's epsilon


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclass
class Ctx:
    train: bool = False
    generator: torch.Generator | None = None
    dropout: float = 0.0
    q: Callable[[torch.Tensor], torch.Tensor] = exact
    moments: dict | None = None


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """SAME padding of one axis as XLA splits it: ``ceil(size / stride)``
    outputs, the smaller half of the padding first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(ctx: Ctx, p: dict, name: str, x: torch.Tensor, stride: int = 1,
         same: bool = False, groups: int = 1) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if same:
        (h0, h1), (w0, w1) = (same_pads(n, k, stride) for n, k in
                              zip(x.shape[2:], w.shape[2:]))
        x = F.pad(x, (w0, w1, h0, h1))
    return F.conv2d(ctx.q(x), ctx.q(w), b, stride=stride, groups=groups)


def dense(ctx: Ctx, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return ctx.q(x) @ ctx.q(p[f"{name}.weight"]).T + p[f"{name}.bias"]


def batch_norm(ctx: Ctx, p: dict, name: str, x: torch.Tensor,
               dim: int = 1) -> torch.Tensor:
    """``(x - mean) / sqrt(var + 1e-3) * weight + bias`` per index of
    ``dim``; the batch's moments (biased variance) in train mode or while
    ``ctx.moments`` collects them, the running statistics otherwise."""
    shape = [1] * x.ndim
    shape[dim] = -1
    if ctx.train or ctx.moments is not None:
        dims = [d for d in range(x.ndim) if d != dim]
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
        if ctx.moments is not None:
            ctx.moments[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
    if f"{name}.weight" in p:
        y = y * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape)
    return y


def dropout(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """Each element kept with probability ``1 - rate`` and scaled by its
    inverse; the keep mask is one Bernoulli draw of the float32 tensor of
    ``x``'s shape from ``ctx.generator``, the draw the program makes."""
    if not ctx.train or ctx.dropout == 0.0:
        return x
    keep = 1.0 - ctx.dropout
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=ctx.generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def conv_spec(name: str, out_ch: int, in_ch: int, kh: int, kw: int) -> list:
    return [(f"{name}.weight", (out_ch, in_ch, kh, kw), "fan_in"),
            (f"{name}.bias", (out_ch,), "zeros")]


def bn_spec(name: str, width: int, affine: bool = True) -> list:
    out = []
    if affine:
        out += [(f"{name}.weight", (width,), "ones"),
                (f"{name}.bias", (width,), "zeros")]
    return out + [(f"{name}.running_mean", (width,), "stat_mean"),
                  (f"{name}.running_var", (width,), "stat_var")]
