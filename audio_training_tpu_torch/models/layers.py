"""Shared layers, eval mode (port of ``audio_training_tpu/models/layers.py``).

Keras conventions, so logits match the Flax models on converted weights:
BatchNorm epsilon 1e-3, convs VALID with glorot-uniform kernels and zero
bias, explicit LeakyReLU slope.  Layers work on NCHW tensors (H = mel,
W = time); the models' public inputs keep the JAX NHWC layout.

A compute ``dtype`` (e.g. ``torch.bfloat16``) casts activations and weights
at each conv while the parameters stay f32, as Flax's ``dtype`` does.
``_condense_conv``'s custom backward (JAX ``layers.py:39-89``) serves
training only; its forward is the plain conv used here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.ops.features import mag_transform

# Keras BatchNormalization defaults
BN_EPS = 1e-3


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, alpha)


class KerasBatchNorm(nn.Module):
    """BatchNorm with Keras defaults, running statistics only (eval).

    ``feature_dim=1`` is the usual channels BN of an NCHW tensor;
    ``feature_dim=2`` with no scale and no bias is badwinner2's per-mel-row
    BN (``BatchNormalization(axis=1)`` on NHWC, badwinner2.py:66-67).
    Normalization runs in f32 and the result has the input's dtype, as
    Flax's BatchNorm gives it in both badwinner2 uses.
    """

    def __init__(self, num_features: int, feature_dim: int = 1,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__()
        self.feature_dim = feature_dim
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm batch statistics (training) come with ROADMAP.md "
                "queue item 4 (training)"
            )
        if self.feature_dim == 1:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        shape = [1] * x.ndim
        shape[self.feature_dim] = -1
        mul = torch.rsqrt(self.running_var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - self.running_mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(x.dtype)


class MagTransform(nn.Module):
    """Trainable magnitude compression ``x**sigmoid(a)`` with ``a`` clipped
    to [-2, 1] (badwinner2.MagTransform, badwinner2.py:32-49)."""

    def __init__(self, init_value: float = -1.0):
        super().__init__()
        self.a_power = nn.Parameter(torch.full((1,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mag_transform(x, self.a_power.clamp(-2.0, 1.0).to(x.dtype))


def logmeanexp(x: torch.Tensor, dim: int, sharpness: float = 5.0,
               keepdim: bool = True) -> torch.Tensor:
    """Log-mean-exp pooling (badwinner2.LMELayer, badwinner2.py:343-355)."""
    lse = torch.logsumexp(x * sharpness, dim=dim, keepdim=keepdim)
    return (lse - math.log(x.shape[dim])) / sharpness


class LMELayer(nn.Module):
    """Log-mean-exp pooling over NCHW dim ``dim`` (2 = mel, 3 = time)."""

    def __init__(self, dim: int, sharpness: float = 5.0):
        super().__init__()
        self.dim = dim
        self.sharpness = sharpness

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logmeanexp(x, self.dim, self.sharpness)


class Conv(nn.Module):
    """Keras-style Conv2D on NCHW: VALID padding, stride 1, glorot-uniform
    (or orthogonal) kernel, zero bias.  ``weight`` is OIHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], init: str = "glorot",
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if init == "glorot":
            nn.init.xavier_uniform_(self.weight, generator=generator)
        elif init == "orthogonal":
            nn.init.orthogonal_(self.weight, generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return F.conv2d(x, w, b)


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Keras MaxPool2D semantics: stride = window, valid padding."""
    return F.max_pool2d(x, tuple(window), tuple(window))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """GlobalAveragePooling2D over (H, W) of NCHW."""
    return x.mean(dim=(2, 3))
