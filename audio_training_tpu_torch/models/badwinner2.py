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
does.  ``external_frontend=True`` takes an image that already ran the
frontend (MagTransform and the per-mel-row BN: the fused featurizer's
``frontend_params`` fold) and builds neither.  ``big_condense=False``
squashes the mel rows with two convs, (28x3) and (17x3), each with its
LReLU and BN; ``add_dense=False`` stops after the last dropout and returns
the (B, H, W, 1024) NHWC map, as JAX does.

``BadWinner2Res`` is the badwinner2-res variant (JAX ``:134-228``,
badwinner2.build_model_res): LeakyReLU at Keras' default 0.3, two
four-conv residual blocks, a (48x3) condense for 160 mels (or (14x3) and
(22x3)), no (5,3) pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    KerasBatchNorm,
    LMELayer,
    MagTransform,
    conv_bn,
    dropout,
    global_avg_pool,
    leaky_relu,
    max_pool,
)

CONDENSE_HEIGHT = {160: 44, 96: 22}  # squashes the remaining mel rows to 5
SMALL_CONDENSE = ((28, 3), (17, 3))  # big_condense=False, JAX :98-103
LEAKY_ALPHA = 0.01
RES_LEAKY_ALPHA = 0.3  # Keras LeakyReLU's default, badwinner2-res


class BadWinner2(nn.Module):
    """Module names map onto the Flax tree (models/convert.py): ``convs[i]``
    is ``Conv_i`` and ``bns[i]`` the ``KerasBatchNorm`` after it
    (``KerasBatchNorm_{i+1}``; with ``external_frontend`` Flax builds no
    frontend and it is ``KerasBatchNorm_i``), ``mel_bn`` is
    ``KerasBatchNorm_0`` and ``mag`` is ``MagTransform_0``."""

    flax_kind = "BadWinner2"

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
        external_frontend: bool = False,
        big_condense: bool = True,
        add_dense: bool = True,
    ):
        super().__init__()
        if big_condense and n_mels not in CONDENSE_HEIGHT:
            raise ValueError(f"Unhandled mel channels {n_mels}")
        self.n_mels = n_mels
        self.dropout = dropout
        self.multi_label = multi_label
        self.logits_only = logits_only
        self.dtype = dtype
        self.mag = self.mel_bn = None
        if not external_frontend:
            self.mag = MagTransform()
            self.mel_bn = KerasBatchNorm(n_mels, feature_dim=2,
                                         use_scale=False, use_bias=False)
        condense = ([(CONDENSE_HEIGHT[n_mels], 3)] if big_condense
                    else list(SMALL_CONDENSE))
        self.n_condense = len(condense)
        convs = [
            (in_channels, 64, (3, 3), "glorot"),
            (64, 64, (3, 3), "glorot"),
            (64, 128, (3, 3), "glorot"),
            (128, 128, (3, 3), "glorot"),
            *((128, 128, k, "glorot") for k in condense),
            (128, 1024, (1, 9), "orthogonal"),
            (1024, 1024, (1, 1), "orthogonal"),
        ]
        bn_widths = [co for _, co, _, _ in convs]
        if add_dense:
            convs.append((1024, num_labels, (1, 1), "orthogonal"))
        self.convs = nn.ModuleList(
            Conv(ci, co, k, init, dtype=dtype, generator=generator)
            for ci, co, k, init in convs
        )
        self.bns = nn.ModuleList(KerasBatchNorm(co) for co in bn_widths)
        self.add_dense = add_dense
        self.lme = (
            nn.Sequential(LMELayer(dim=2), LMELayer(dim=3)) if lme else None
        )

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """``bns[i](leaky_relu(convs[i](x)))``; in eval on the card one
        epilogue kernel after the bias-free conv (``layers.conv_bn``)."""
        return conv_bn(self.convs[i], self.bns[i], x, "leaky_relu",
                       LEAKY_ALPHA, act_first=True)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, n_mels, frames, C) -> (B, num_labels) f32 (the NHWC
        feature map without the dense head); ``generator`` draws the
        dropout masks in training mode."""
        if x.shape[1] != self.n_mels:
            raise ValueError(
                f"expected {self.n_mels} mel rows, got input {tuple(x.shape)}"
            )
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last
        x = x.permute(0, 3, 1, 2)
        if self.mag is not None:
            x = self.mel_bn(self.mag(x))
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._block(1, self._block(0, x))
        x = max_pool(x, (3, 3))
        for i in range(2, 4 + self.n_condense):
            x = self._block(i, x)
        drop = lambda t: dropout(  # noqa: E731
            t, self.dropout, self.training, generator)
        x = drop(max_pool(x, (5, 3)))
        head = 4 + self.n_condense
        x = drop(self._block(head, x))
        x = drop(self._block(head + 1, x))
        if not self.add_dense:
            return x.permute(0, 2, 3, 1)
        x = leaky_relu(self.convs[head + 2](x), LEAKY_ALPHA)
        if self.lme is not None:
            x = self.lme(x)
        x = global_avg_pool(x).float()
        if self.logits_only:
            return x
        return torch.sigmoid(x) if self.multi_label else torch.softmax(x, -1)


class ResBlock(nn.Module):
    """[BN -> ReLU -> Conv 3x3 SAME] x4 plus a 1x1-conv shortcut, then ReLU
    (badwinner2.res_block, JAX badwinner2.py:134-163)."""

    flax_kind = "ResBlock"

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=None, generator=None):
        super().__init__()
        s = (stride, stride)
        bns, convs, width = [], [], in_channels
        for _ in range(4):
            bns.append(KerasBatchNorm(width))
            convs.append(Conv(width, filters, (3, 3), stride=s,
                              padding="SAME", dtype=dtype,
                              generator=generator))
            width = filters
        self.bns, self.convs = nn.ModuleList(bns), nn.ModuleList(convs)
        self.short = Conv(in_channels, filters, (1, 1), stride=s,
                          padding="SAME", dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for bn, conv in zip(self.bns, self.convs):
            y = conv(F.relu(bn(y)))
        return F.relu(y + self.short(x))


class BadWinner2Res(nn.Module):
    """badwinner2-res (JAX ``badwinner2.py:166-228``); module names map onto
    the Flax tree as ``BadWinner2``'s do."""

    flax_kind = "BadWinner2Res"

    def __init__(self, num_labels: int, n_mels: int = 160,
                 in_channels: int = 1, multi_label: bool = True,
                 logits_only: bool = False, dtype=None, generator=None,
                 dropout: float = 0.5, big_condense: bool = True,
                 add_dense: bool = True):
        super().__init__()
        if big_condense and n_mels != 160:
            raise ValueError(f"Unhandled mel channels {n_mels}")
        self.n_mels, self.dtype, self.dropout = n_mels, dtype, dropout
        self.multi_label, self.logits_only = multi_label, logits_only
        self.big_condense, self.add_dense = big_condense, add_dense
        conv = lambda ci, co, k, init="glorot": Conv(  # noqa: E731
            ci, co, k, init, dtype=dtype, generator=generator)
        self.mag = MagTransform()
        self.mel_bn = KerasBatchNorm(n_mels, feature_dim=2, use_scale=False,
                                     use_bias=False)
        self.stem = conv(in_channels, 64, (3, 3))
        self.stem_bn = KerasBatchNorm(64)
        self.res1 = ResBlock(64, 64, dtype=dtype, generator=generator)
        self.res2 = ResBlock(64, 128, dtype=dtype, generator=generator)
        self.res_bn = KerasBatchNorm(128)
        if big_condense:
            self.condense = nn.ModuleList([conv(128, 128, (48, 3))])
        else:
            self.condense = nn.ModuleList([conv(128, 128, (14, 3)),
                                           conv(128, 128, (22, 3))])
        self.condense_bn = KerasBatchNorm(128)
        self.conv_a = conv(128, 1024, (1, 9), "orthogonal")
        self.bn_a = KerasBatchNorm(1024)
        self.conv_b = conv(1024, 1024, (1, 1), "orthogonal")
        self.bn_b = KerasBatchNorm(1024)
        self.out = (conv(1024, num_labels, (1, 1), "orthogonal")
                    if add_dense else None)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, n_mels, frames, C) NHWC -> (B, num_labels) f32."""
        a, drop = RES_LEAKY_ALPHA, lambda t: dropout(  # noqa: E731
            t, self.dropout, self.training, generator)
        x = self.mel_bn(self.mag(x.permute(0, 3, 1, 2)))
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem_bn(leaky_relu(self.stem(x), a))
        x = max_pool(self.res1(x), (3, 3))
        x = F.relu(self.res_bn(self.res2(x)))
        x = leaky_relu(self.condense[0](x), a)
        x = self.condense_bn(x)
        if not self.big_condense:
            x = leaky_relu(self.condense[1](x), a)
        x = drop(x)
        x = drop(self.bn_a(leaky_relu(self.conv_a(x), a)))
        x = drop(self.bn_b(leaky_relu(self.conv_b(x), a)))
        if self.out is None:
            return x.permute(0, 2, 3, 1)
        x = global_avg_pool(leaky_relu(self.out(x), a)).float()
        if self.logits_only:
            return x
        return torch.sigmoid(x) if self.multi_label else torch.softmax(x, -1)
