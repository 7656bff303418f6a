"""badwinner2, plain (the reference's ``badwinner2.build_model``,
badwinner2.py:212-324), on NCHW float32 (B, 1, mels, frames):

    x ** sigmoid(clip(a, -2, 1)) -> BatchNorm per mel row (no scale, no bias)
    -> [Conv 64 3x3 -> LeakyReLU(0.01) -> BatchNorm] x 2 -> MaxPool 3x3
    -> [Conv 128 3x3 -> LeakyReLU -> BatchNorm] x 2
    -> Conv 128 (44 x 3 for 160 mels) -> LeakyReLU -> BatchNorm
    -> MaxPool (5, 3) -> Dropout
    -> Conv 1024 1x9 -> LeakyReLU -> BatchNorm -> Dropout
    -> Conv 1024 1x1 -> LeakyReLU -> BatchNorm -> Dropout
    -> Conv labels 1x1 -> LeakyReLU -> mean over mels and frames: logits

Convolutions are VALID with a bias.  Names follow the program's
``state_dict``: ``convs.i`` and ``bns.i`` in the order above, ``mag`` and
``mel_bn`` for the frontend.
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
    dropout,
)

SLOPE = 0.01
CONDENSE = {160: 44, 96: 22}


def spec(num_labels: int, geometry: dict, channels: int = 1) -> list:
    """(name, shape, init) of every tensor, in the program's names."""
    n_mels = geometry["n_mels"]
    widths = [(channels, 64, 3, 3), (64, 64, 3, 3), (64, 128, 3, 3),
              (128, 128, 3, 3), (128, 128, CONDENSE[n_mels], 3),
              (128, 1024, 1, 9), (1024, 1024, 1, 1)]
    out = [("mag.a_power", (1,), "const:-1.0"),
           *bn_spec("mel_bn", n_mels, affine=False)]
    for i, (ci, co, kh, kw) in enumerate(widths):
        out += conv_spec(f"convs.{i}", co, ci, kh, kw)
    out += conv_spec(f"convs.{len(widths)}", num_labels, 1024, 1, 1)
    for i, (_, co, _, _) in enumerate(widths):
        out += bn_spec(f"bns.{i}", co)
    return out


def forward(ctx: Ctx, p: dict, x: torch.Tensor) -> torch.Tensor:
    def block(i, t):
        return batch_norm(ctx, p, f"bns.{i}",
                          F.leaky_relu(conv(ctx, p, f"convs.{i}", t), SLOPE))

    x = x ** torch.sigmoid(p["mag.a_power"].clamp(-2.0, 1.0))
    x = batch_norm(ctx, p, "mel_bn", x, dim=2)
    x = F.max_pool2d(block(1, block(0, x)), 3)
    for i in (2, 3, 4):
        x = block(i, x)
    x = dropout(ctx, F.max_pool2d(x, (5, 3)))
    x = dropout(ctx, block(5, x))
    x = dropout(ctx, block(6, x))
    x = F.leaky_relu(conv(ctx, p, "convs.7", x), SLOPE)
    return x.mean(dim=(2, 3))
