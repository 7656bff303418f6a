"""CNN backbones (port of ``audio_training_tpu/models/backbones.py``).

Headless, as the JAX package runs them (``include_top=False``): an NCHW
image in, a (B, C', H', W') feature map out; ``models.registry.
BackboneClassifier`` adds the frontend, pooling and head.  Only MobileNetV2
is ported (JAX ``backbones.py:173-219``); the other families are ROADMAP
queue item 5.

Module names map one to one onto the Flax tree (``models/convert.py``).
Convolutions are SAME-padded with XLA's split (``layers.same_pads``).  A
compute ``dtype`` casts the input at entry and the activations and weights
at each conv while parameters stay f32, as Flax's ``dtype`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_training_tpu_torch.models.layers import Conv, KerasBatchNorm, relu6

# (expand, filters, repeats, stride) per stage, JAX backbones.py:211-212
MOBILENET_V2_SPEC = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                     (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                     (6, 320, 1, 1))


class InvertedResidual(nn.Module):
    """1x1 expand (when ``expand`` != 1) -> BN -> ReLU6 -> 3x3 depthwise
    (stride ``stride``) -> BN -> ReLU6 -> 1x1 project -> BN, plus the input
    when the stride is 1 and the width is kept.  The depthwise conv is
    Flax's plain ``nn.Conv`` with a bias and its default lecun-normal init
    (JAX ``backbones.py:188-190``; Keras' has no bias)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 expand: int = 6, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        hidden = in_channels * expand
        self.residual = stride == 1 and in_channels == filters
        if expand != 1:
            self.expand = Conv(in_channels, hidden, (1, 1), padding="SAME",
                               dtype=dtype, generator=generator)
            self.expand_bn = KerasBatchNorm(hidden)
        else:
            self.expand = self.expand_bn = None
        self.depthwise = Conv(hidden, hidden, (3, 3), "lecun_normal",
                              dtype=dtype, generator=generator,
                              stride=(stride, stride), padding="SAME",
                              groups=hidden)
        self.depthwise_bn = KerasBatchNorm(hidden)
        self.project = Conv(hidden, filters, (1, 1), padding="SAME",
                            dtype=dtype, generator=generator)
        self.project_bn = KerasBatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = relu6(self.expand_bn(self.expand(y)))
        y = relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """Stem Conv32 3x3/2 -> BN -> ReLU6 -> 17 inverted residual blocks ->
    Conv1280 1x1 -> BN -> ReLU6."""

    def __init__(self, in_channels: int = 3, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(in_channels, 32, (3, 3), dtype=dtype,
                         generator=generator, stride=(2, 2), padding="SAME")
        self.stem_bn = KerasBatchNorm(32)
        blocks, width = [], 32
        for expand, filters, repeats, stride in MOBILENET_V2_SPEC:
            for i in range(repeats):
                blocks.append(InvertedResidual(
                    width, filters, stride if i == 0 else 1, expand,
                    dtype=dtype, generator=generator))
                width = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv(width, 1280, (1, 1), padding="SAME", dtype=dtype,
                         generator=generator)
        self.head_bn = KerasBatchNorm(1280)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = relu6(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        return relu6(self.head_bn(self.head(x)))


BACKBONES = {"mobilenet": MobileNetV2}
