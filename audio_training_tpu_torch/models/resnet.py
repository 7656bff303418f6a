"""Hand-rolled headless ResNet50, port of
``audio_training_tpu/models/resnet.py`` (reference resnet/resnet.py): the
original paper's quirks kept (ZeroPadding 3 + VALID 7x7/2 stem, VALID 3x3/2
max pool with no pad, the downsampling stride on the FIRST 1x1 conv of each
convolutional block, stage 2 at stride 1, a 2x2/2 average pool + Flatten
instead of global pooling; the flatten runs in NHWC order, as JAX's).  Not
in ``build_model``: the registry's "resnet" is ``backbones.ResNet``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    KerasBatchNorm,
    zero_pad,
)


class IdentityBlock(nn.Module):
    """1x1 -> fxf (SAME) -> 1x1 bottleneck with the identity shortcut."""

    flax_kind = "IdentityBlock"

    def __init__(self, in_channels: int, f: int, filters: Sequence[int],
                 dtype=None, generator=None, stride: int = 1):
        super().__init__()
        f1, f2, f3 = filters
        self.conv1 = Conv(in_channels, f1, (1, 1), stride=(stride, stride),
                          dtype=dtype, generator=generator)
        self.bn1 = KerasBatchNorm(f1)
        self.conv2 = Conv(f1, f2, (f, f), padding="SAME", dtype=dtype,
                          generator=generator)
        self.bn2 = KerasBatchNorm(f2)
        self.conv3 = Conv(f2, f3, (1, 1), dtype=dtype, generator=generator)
        self.bn3 = KerasBatchNorm(f3)

    def _main(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self.bn3(self.conv3(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self._main(x) + x)


class ConvolutionalBlock(IdentityBlock):
    """The bottleneck with a projected shortcut; stride ``s`` on the first
    1x1 conv and on the projection."""

    flax_kind = "ConvolutionalBlock"

    def __init__(self, in_channels: int, f: int, filters: Sequence[int],
                 s: int = 2, dtype=None, generator=None):
        super().__init__(in_channels, f, filters, dtype, generator, stride=s)
        self.short = Conv(in_channels, filters[2], (1, 1), stride=(s, s),
                          dtype=dtype, generator=generator)
        self.short_bn = KerasBatchNorm(filters[2])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self._main(x) + self.short_bn(self.short(x)))


# (stride, mid kernel, filters, identity-block count) per stage
# (resnet.py:38-60)
_STAGES = (
    (1, 3, (64, 64, 256), 2),
    (2, 3, (128, 128, 512), 3),
    (2, 3, (256, 256, 1024), 5),
    (2, 3, (512, 512, 2048), 2),
)


class ResNet50(nn.Module):
    """(B, C, H, W) -> (B, H' * W' * 2048), the flattened post-pool map."""

    flax_kind = "ResNet50"

    def __init__(self, in_channels: int = 3, dtype=None, generator=None):
        super().__init__()
        self.stem = Conv(in_channels, 64, (7, 7), stride=(2, 2), dtype=dtype,
                         generator=generator)
        self.stem_bn = KerasBatchNorm(64)
        blocks, width = [], 64
        for s, f, filters, n_id in _STAGES:
            blocks.append(ConvolutionalBlock(width, f, filters, s, dtype,
                                             generator))
            width = filters[2]
            blocks += [IdentityBlock(width, f, filters, dtype, generator)
                       for _ in range(n_id)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(zero_pad(x, 3))))
        x = F.max_pool2d(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = F.avg_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# reference naming (resnet.py:79, :146)
identity_block = IdentityBlock
convolutional_block = ConvolutionalBlock

__all__ = ["ResNet50", "IdentityBlock", "ConvolutionalBlock",
           "identity_block", "convolutional_block"]
