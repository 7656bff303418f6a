"""badwinner v1, the superseded small CNN (port of
``audio_training_tpu/models/badwinner.py``; reference badwinner.py:47-94):
MagTransform (``a`` starts at 0.0, not v2's -1.0) -> channels BN -> three
conv / pool stages of 16 filters -> Dense 256 and 32 acting pointwise on
the channels of the 4-D map (Keras' Dense on a 4-D tensor) -> global
average pool -> Dense(num_labels) -> sigmoid / softmax.  LeakyReLU at 0.3.
Module names map onto the Flax tree (``models/convert.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    Dense,
    KerasBatchNorm,
    MagTransform,
    dropout,
    leaky_relu,
    max_pool,
)

ALPHA = 0.3


class BadWinner(nn.Module):
    flax_kind = "BadWinner"

    def __init__(self, num_labels: int, in_channels: int = 1,
                 multi_label: bool = False, filters: int = 16,
                 logits_only: bool = False, dtype=None, generator=None):
        super().__init__()
        self.dtype, self.multi_label = dtype, multi_label
        self.logits_only = logits_only
        self.mag = MagTransform(init_value=0.0)
        self.bn = KerasBatchNorm(in_channels)
        self.convs = nn.ModuleList(
            Conv(ci, filters, k, dtype=dtype, generator=generator)
            for ci, k in ((in_channels, (3, 3)), (filters, (3, 3)),
                          (filters, (1, 3))))
        self.dense = nn.ModuleList([
            Dense(filters, 256, dtype=dtype, generator=generator),
            Dense(256, 32, dtype=dtype, generator=generator)])
        self.out = Dense(32, num_labels, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, mel, frames, C) NHWC -> (B, num_labels) f32."""
        x = self.bn(self.mag(x.permute(0, 3, 1, 2)))
        if self.dtype is not None:
            x = x.to(self.dtype)
        for conv, window in zip(self.convs, ((3, 3), (3, 3), (1, 3))):
            x = max_pool(leaky_relu(conv(x), ALPHA), window)
        x = dropout(x.permute(0, 2, 3, 1), 0.5, self.training, generator)
        for dense in self.dense:
            x = dropout(leaky_relu(dense(x), ALPHA), 0.5, self.training,
                        generator)
        x = self.out(x.mean((1, 2)).float())
        if self.logits_only:
            return x
        return torch.sigmoid(x) if self.multi_label else torch.softmax(x, -1)
