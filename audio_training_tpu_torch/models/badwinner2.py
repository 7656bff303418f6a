"""badwinner2 — the flagship CNN (port of
``audio_training_tpu/models/badwinner2.py:43-131``; architecture of the
reference ``badwinner2.build_model``, badwinner2.py:212-324):

    (B, 160 mels, 513 frames, C)  NHWC, as in the JAX package
    -> MagTransform (x**sigmoid(a)) -> per-mel-row BN (no scale/center)
    -> [Conv64 3x3 + LeakyReLU(0.01) + BN] x2 -> MaxPool 3x3
    -> [Conv128 3x3 + LReLU + BN] x2
    -> "big condense" Conv128 (44x3) for 160 mels / (22x3) for 96
    -> MaxPool (5,3) -> Dropout
    -> Conv1024 (1x9, orthogonal) -> LReLU -> BN -> Dropout
    -> Conv1024 (1x1, orthogonal) -> LReLU -> BN -> Dropout
    -> Conv(num_labels, 1x1, orthogonal) -> LReLU
    -> [optional LME pool over mel then time, sharpness 5]
    -> GlobalAvgPool -> sigmoid (multi-label) | softmax

``.train()`` is Flax's ``train=True``: BatchNorm on batch moments with
Flax's running-statistics update, and dropout at rate ``dropout`` (0.5) in
JAX's three places (``:106``, ``:111``, ``:116``), drawn from the
``generator`` given to ``forward`` (JAX keys and torch generators give
different bits: parity is held at ``dropout=0.0``).  ``dtype=torch.bfloat16``
runs the CNN in bf16 after the frontend while parameters stay f32, as Flax
does.  The JAX options ``big_condense=False``, ``add_dense=False`` and
``external_frontend`` are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    KerasBatchNorm,
    LMELayer,
    MagTransform,
    global_avg_pool,
    leaky_relu,
    max_pool,
)

CONDENSE_HEIGHT = {160: 44, 96: 22}  # squashes the remaining mel rows to 5
LEAKY_ALPHA = 0.01


class BadWinner2(nn.Module):
    """Module names map one to one onto the Flax tree (models/convert.py):
    ``convs[i]`` is ``Conv_i``, ``bns[i]`` is ``KerasBatchNorm_{i+1}``,
    ``mel_bn`` is ``KerasBatchNorm_0`` and ``mag`` is ``MagTransform_0``."""

    def __init__(
        self,
        num_labels: int,
        n_mels: int = 160,
        in_channels: int = 1,
        multi_label: bool = True,
        lme: bool = False,
        logits_only: bool = False,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
        dropout: float = 0.5,
    ):
        super().__init__()
        if n_mels not in CONDENSE_HEIGHT:
            raise ValueError(f"Unhandled mel channels {n_mels}")
        self.n_mels = n_mels
        self.dropout = dropout
        self.multi_label = multi_label
        self.logits_only = logits_only
        self.dtype = dtype
        self.mag = MagTransform()
        self.mel_bn = KerasBatchNorm(n_mels, feature_dim=2, use_scale=False,
                                     use_bias=False)
        convs = [
            (in_channels, 64, (3, 3), "glorot"),
            (64, 64, (3, 3), "glorot"),
            (64, 128, (3, 3), "glorot"),
            (128, 128, (3, 3), "glorot"),
            (128, 128, (CONDENSE_HEIGHT[n_mels], 3), "glorot"),
            (128, 1024, (1, 9), "orthogonal"),
            (1024, 1024, (1, 1), "orthogonal"),
            (1024, num_labels, (1, 1), "orthogonal"),
        ]
        self.convs = nn.ModuleList(
            Conv(ci, co, k, init, dtype=dtype, generator=generator)
            for ci, co, k, init in convs
        )
        self.bns = nn.ModuleList(
            KerasBatchNorm(co) for _, co, _, _ in convs[:-1]
        )
        self.lme = (
            nn.Sequential(LMELayer(dim=2), LMELayer(dim=3)) if lme else None
        )

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.bns[i](leaky_relu(self.convs[i](x), LEAKY_ALPHA))

    def _dropout(self, x: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
        """Flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
        1 / (1 - rate); the identity in eval or at rate 0."""
        if not self.training or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, n_mels, frames, C) -> (B, num_labels) f32; ``generator``
        draws the dropout masks in training mode."""
        if x.shape[1] != self.n_mels:
            raise ValueError(
                f"expected {self.n_mels} mel rows, got input {tuple(x.shape)}"
            )
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last
        x = x.permute(0, 3, 1, 2)
        x = self.mel_bn(self.mag(x))
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._block(1, self._block(0, x))
        x = max_pool(x, (3, 3))
        x = self._block(4, self._block(3, self._block(2, x)))
        x = self._dropout(max_pool(x, (5, 3)), generator)
        x = self._dropout(self._block(5, x), generator)
        x = self._dropout(self._block(6, x), generator)
        x = leaky_relu(self.convs[7](x), LEAKY_ALPHA)
        if self.lme is not None:
            x = self.lme(x)
        x = global_avg_pool(x).float()
        if self.logits_only:
            return x
        return torch.sigmoid(x) if self.multi_label else torch.softmax(x, -1)
