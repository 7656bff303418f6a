"""EfficientNetV2-B3 classifier, plain (Tan & Le 2021, arXiv:2104.00298;
``keras.applications.EfficientNetV2B3`` with ``include_preprocessing``, as
the reference's ``get_base_model`` builds it, audiomodel.py:1020-1141,
with global average pooling, dropout and a dense layer), on NCHW float32
(B, 3, mels, frames):

    (x / 255 - ImageNet mean) / ImageNet std
    -> Conv 40 3x3 stride 2 -> BatchNorm -> SiLU
    -> 35 MBConv blocks in six stages -> Conv 1536 1x1 -> BatchNorm -> SiLU
    -> mean over mels and frames -> Dense(labels): logits

A fused block is a kxk conv (stride on it) -> BatchNorm -> SiLU, then,
when it expands, a 1x1 projection -> BatchNorm.  An MBConv block is a 1x1
expansion -> BatchNorm -> SiLU, a kxk depthwise conv (stride on it) ->
BatchNorm -> SiLU, squeeze-excite (spatial mean -> 1x1 conv to a quarter
of the block's input width -> SiLU -> 1x1 conv -> sigmoid, times the
input), a 1x1 projection -> BatchNorm.  A block adds its input back when
its stride is 1 and its width is kept.  Convolutions are SAME-padded as
XLA splits the padding, with a bias.  Names follow the program's
``state_dict`` (``backbone.*``, ``dense``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import (
    Ctx,
    batch_norm,
    bn_spec,
    conv,
    conv_spec,
    dense,
)

# (expand, filters, repeats, stride, kernel, fused) per stage
STAGES = ((1, 16, 2, 1, 3, True), (4, 40, 3, 2, 3, True),
          (4, 56, 3, 2, 3, True), (4, 112, 5, 2, 3, False),
          (6, 136, 7, 1, 3, False), (6, 232, 12, 2, 3, False))
STEM, HEAD = 40, 1536
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SE_RATIO = 0.25


def blocks(stem: int = STEM):
    """(in, out, expand, stride, kernel, fused) of each block."""
    out, ch = [], stem
    for expand, filters, repeats, stride, kernel, fused in STAGES:
        for i in range(repeats):
            out.append((ch, filters, expand, stride if i == 0 else 1,
                        kernel, fused))
            ch = filters
    return out


def spec(num_labels: int, geometry: dict, channels: int = 3) -> list:
    """(name, shape, init) of every tensor, in the program's names."""
    out = [*conv_spec("backbone.stem", STEM, channels, 3, 3),
           *bn_spec("backbone.stem_bn", STEM)]
    for i, (ci, co, expand, _, k, fused) in enumerate(blocks()):
        b, mid = f"backbone.blocks.{i}", ci * expand
        if fused:
            width = co if expand == 1 else mid
            out += conv_spec(f"{b}.expand", width, ci, k, k)
            out += bn_spec(f"{b}.expand_bn", width)
        else:
            out += conv_spec(f"{b}.expand", mid, ci, 1, 1)
            out += bn_spec(f"{b}.expand_bn", mid)
            out += conv_spec(f"{b}.depthwise", mid, 1, k, k)
            out += bn_spec(f"{b}.depthwise_bn", mid)
            se = max(1, int(ci * SE_RATIO))
            out += conv_spec(f"{b}.se.reduce", se, mid, 1, 1)
            out += conv_spec(f"{b}.se.expand", mid, se, 1, 1)
        if not (fused and expand == 1):
            out += conv_spec(f"{b}.project", co, mid, 1, 1)
            out += bn_spec(f"{b}.project_bn", co)
    out += [*conv_spec("backbone.head", HEAD, blocks()[-1][1], 1, 1),
            *bn_spec("backbone.head_bn", HEAD),
            ("dense.weight", (num_labels, HEAD), "fan_in"),
            ("dense.bias", (num_labels,), "zeros")]
    return out


def forward(ctx: Ctx, p: dict, x: torch.Tensor) -> torch.Tensor:
    def cbs(name, t, stride=1, groups=1, act=True):
        t = batch_norm(ctx, p, f"{name}_bn", conv(
            ctx, p, name, t, stride=stride, same=True, groups=groups))
        return F.silu(t) if act else t

    mean = torch.tensor(MEAN, device=x.device).view(1, -1, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, -1, 1, 1)
    x = (x / 255.0 - mean) / std
    x = cbs("backbone.stem", x, stride=2)
    for i, (ci, co, expand, stride, _, fused) in enumerate(blocks()):
        b = f"backbone.blocks.{i}"
        y = cbs(f"{b}.expand", x, stride=stride if fused else 1)
        if not fused:
            y = cbs(f"{b}.depthwise", y, stride=stride, groups=y.shape[1])
            s = y.mean(dim=(2, 3), keepdim=True)
            s = conv(ctx, p, f"{b}.se.expand",
                     F.silu(conv(ctx, p, f"{b}.se.reduce", s)))
            y = y * torch.sigmoid(s)
        if not (fused and expand == 1):
            y = cbs(f"{b}.project", y, act=False)
        x = y + x if stride == 1 and ci == co else y
    x = cbs("backbone.head", x).mean(dim=(2, 3))
    return dense(ctx, p, "dense", x)
