"""BirdNET-flavoured WideResNet, port of
``audio_training_tpu/models/wr_resnet_bird.py`` (reference
resnet/wr_resnet_bird.py): 5x5 stem + BN + MaxPool(1,2), three stride-2
stages of basic blocks (a BN-ReLU-1x1 pre-conv before downsampling,
MaxPool(2,2) in the main path, AvgPool + 1x1-conv shortcuts), head
Conv(4x10) -> Conv1x1 -> Conv(classes) -> log-mean-exp pooling (sharpness
5) -> Dense -> sigmoid.

``keras_slip_compat=True`` reproduces the reference's three slips, as JAX
does: the pre- and mid-convs take the tensor's MEL height as their width,
the head is 128 wide whatever ``k``, and the second log-mean-exp pools the
class axis, so the Dense reads (B, W).  Both depend on the image, so the
model takes ``n_mels`` and ``mel_frames``.  Module names map onto the Flax
tree (``models/convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    Dense,
    KerasBatchNorm,
    avg_pool,
    dropout,
    logmeanexp,
    max_pool,
)


class BirdBasicBlock(nn.Module):
    flax_kind = "BirdBasicBlock"

    def __init__(self, in_channels: int, height: int, filters: int,
                 kernel=(3, 3), stride: int = 1, final_relu: bool = True,
                 keras_slip_compat: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        conv = lambda ci, co, k: Conv(  # noqa: E731
            ci, co, k, padding="SAME", dtype=dtype, generator=generator)
        self.stride, self.final_relu = stride, final_relu
        width = in_channels
        self.pre_bn = self.pre = None
        if stride > 1:
            self.pre_bn = KerasBatchNorm(width)
            out = height if keras_slip_compat else width
            self.pre = conv(width, out, (1, 1))
            width = out
        self.bn1 = KerasBatchNorm(width)
        out = height if keras_slip_compat else width
        self.conv1 = conv(width, out, kernel)
        self.bn2 = KerasBatchNorm(out)
        self.conv2 = conv(out, filters, kernel)
        self.short = (None if filters == in_channels and stride == 1
                      else conv(in_channels, filters, (1, 1)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = x
        if self.pre is not None:
            y = self.pre(F.relu(self.pre_bn(y)))
        y = self.conv1(F.relu(self.bn1(y)))
        if self.stride > 1:
            y = max_pool(y, (self.stride, self.stride))
        y = dropout(y, 0.1, self.training, generator)
        y = self.conv2(F.relu(self.bn2(y)))
        shortcut = x
        if self.short is not None:
            shortcut = self.short(avg_pool(x, (self.stride, self.stride),
                                           padding="SAME"))
        y = y + shortcut
        return F.relu(y) if self.final_relu else y


class WRResNetBird(nn.Module):
    flax_kind = "WRResNetBird"

    def __init__(self, classes: int, in_channels: int = 1, n_mels: int = 160,
                 mel_frames: int = 513, depth: int = 22, k: int = 4,
                 logits_only: bool = False, keras_slip_compat: bool = False,
                 dtype=None, generator=None):
        super().__init__()
        self.dtype, self.logits_only = dtype, logits_only
        self.keras_slip_compat = keras_slip_compat
        filters = [16, 16 * k, 32 * k, 64 * k]
        kernels = [(5, 5), (3, 3), (3, 3), (3, 3)]
        head = 128 if keras_slip_compat else 128 * k
        n = int((depth - 4) / 6)
        conv = lambda ci, co, kk: Conv(  # noqa: E731
            ci, co, kk, padding="SAME", dtype=dtype, generator=generator)
        self.stem = conv(in_channels, filters[0], kernels[0])
        self.stem_bn = KerasBatchNorm(filters[0])
        blocks, width = [], filters[0]
        height, frames = n_mels, mel_frames // 2
        for stage in range(1, 4):
            for d in range(n):
                stride = 2 if d == 0 else 1
                # no ReLU after the very first residual add
                # (resnet/wr_resnet_bird.py:177-178)
                blocks.append(BirdBasicBlock(
                    width, height, filters[stage], kernels[stage], stride,
                    final_relu=stage + d > 1,
                    keras_slip_compat=keras_slip_compat, dtype=dtype,
                    generator=generator))
                width = filters[stage]
                if stride > 1:
                    height, frames = height // 2, frames // 2
        self.blocks = nn.ModuleList(blocks)
        self.bn = KerasBatchNorm(width)
        self.head1 = conv(width, head, (4, 10))
        self.head1_bn = KerasBatchNorm(head)
        self.head2 = conv(head, head * 2, (1, 1))
        self.head2_bn = KerasBatchNorm(head * 2)
        self.head3 = conv(head * 2, classes, (1, 1))
        self.dense = Dense(frames if keras_slip_compat else classes, classes,
                           generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, mel, frames, C) NHWC -> (B, classes) f32."""
        drop = lambda t: dropout(t, 0.1, self.training, generator)  # noqa: E731
        x = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = max_pool(self.stem_bn(self.stem(x)), (1, 2))
        for block in self.blocks:
            x = block(x, generator)
        x = F.relu(self.bn(x))
        x = drop(self.head1_bn(self.head1(x)))
        x = drop(self.head2_bn(self.head2(x)))
        x = logmeanexp(self.head3(x), 2, 5.0, keepdim=False)  # (B, C, W)
        # compat: the class axis (the reference's slip), else time
        x = logmeanexp(x, 1 if self.keras_slip_compat else 2, 5.0,
                       keepdim=False)
        x = self.dense(x.float())
        return x if self.logits_only else torch.sigmoid(x)
