"""WideResNet (arXiv 1605.07146), port of
``audio_training_tpu/models/wr_resnet.py`` (reference resnet/wr_resnet.py)
with its quirks: the stride equals the stage index (1, 2, 3), pre-activation
basic blocks with dropout 0.1, identity or 1x1-conv shortcuts.  Module
names map onto the Flax tree (``models/convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    Dense,
    KerasBatchNorm,
    dropout,
    global_avg_pool,
)


class BasicBlock(nn.Module):
    """BN -> ReLU -> 3x3 conv (stride) -> dropout 0.1 -> BN -> ReLU -> 3x3
    conv, plus the input or its 1x1-conv projection, then ReLU."""

    flax_kind = "BasicBlock"

    def __init__(self, in_channels: int, f1: int, f2: int, stride: int = 1,
                 dtype=None, generator=None):
        super().__init__()
        s = (stride, stride)
        self.bn1 = KerasBatchNorm(in_channels)
        self.conv1 = Conv(in_channels, f1, (3, 3), stride=s, padding="SAME",
                          dtype=dtype, generator=generator)
        self.bn2 = KerasBatchNorm(f1)
        self.conv2 = Conv(f1, f2, (3, 3), padding="SAME", dtype=dtype,
                          generator=generator)
        self.short = (Conv(in_channels, f2, (1, 1), stride=s, padding="SAME",
                           dtype=dtype, generator=generator)
                      if f2 != in_channels or stride != 1 else None)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = dropout(y, 0.1, self.training, generator)
        y = self.conv2(F.relu(self.bn2(y)))
        return F.relu(y + (x if self.short is None else self.short(x)))


class WRResNet(nn.Module):
    """depth-22, k=4 wide ResNet, filters 16, 16k, 32k, 64k (reference
    resnet/wr_resnet.py:5-33); sigmoid head."""

    flax_kind = "WRResNet"

    def __init__(self, classes: int, in_channels: int = 1, depth: int = 22,
                 k: int = 4, logits_only: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype, self.logits_only = dtype, logits_only
        filters = [16, 16 * k, 32 * k, 64 * k]
        n = int((depth - 4) / 6)
        self.stem = Conv(in_channels, 16, (3, 3), padding="SAME", dtype=dtype,
                         generator=generator)
        blocks, width = [], 16
        for stage, f in enumerate(filters[1:], start=1):
            # the reference passes stride=stage (resnet/wr_resnet.py:21-23)
            for i in range(n):
                blocks.append(BasicBlock(width, f, f, stage if i == 0 else 1,
                                         dtype=dtype, generator=generator))
                width = f
        self.blocks = nn.ModuleList(blocks)
        self.bn = KerasBatchNorm(width)
        self.dense = Dense(width, classes, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, mel, frames, C) NHWC -> (B, classes) f32."""
        x = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem(x)
        for block in self.blocks:
            x = block(x, generator)
        x = self.dense(global_avg_pool(F.relu(self.bn(x))).float())
        return x if self.logits_only else torch.sigmoid(x)
