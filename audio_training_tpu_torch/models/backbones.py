"""CNN backbones (port of ``audio_training_tpu/models/backbones.py``).

Headless, as the JAX package runs them (``include_top=False``): an NCHW
image in, a (B, C', H', W') feature map out, ``out_channels`` wide;
``models.registry.BackboneClassifier`` adds the frontend, pooling and head.
Every family of JAX's ``BACKBONES`` is here: ResNet v1 / v2 / 152, VGG16/19,
MobileNetV2, DenseNet121, EfficientNet B0/B1/B5, EfficientNetV2 B0/B3/S/M,
InceptionV3 and InceptionResNetV2.

Module names map onto the Flax tree (``models/convert.py``): a module's
children are numbered per Flax kind in the order they are registered,
which is the order Flax creates them in (the keras graph's topological
order where JAX keeps it, e.g. ``BottleneckV1``'s shortcut between its
second and third conv).  Convolutions are SAME-padded with XLA's split
(``layers.same_pads``).  A compute ``dtype`` casts the input at entry and
the activations and weights at each conv while parameters stay f32, as
Flax's ``dtype`` does; BatchNorm returns its input's dtype, and the SE
mean, the pools and the residual adds run in the compute dtype.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.models.layers import (
    Conv,
    KerasBatchNorm,
    conv_bn,
    max_pool,
    relu6,
    same_avg_pool3,
    same_pads,
    silu,
    zero_pad,
)
from audio_training_tpu_torch.utils.profiling import (
    count,
    region,
    register_counters,
)

RESNET_BN_EPS = 1.001e-5  # keras.applications' ResNets and DenseNet

# (expand, filters, repeats, stride) per stage, JAX backbones.py:211-212
MOBILENET_V2_SPEC = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                     (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                     (6, 320, 1, 1))
# (expand, filters, repeats, stride, kernel), JAX backbones.py:388-390
EFFICIENTNET_SPEC = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
                     (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
                     (6, 320, 1, 1, 3))
# (expand, filters, repeats, stride, kernel, fused), stem and head widths,
# JAX backbones.py:432-450
EFFICIENTNET_V2_SPECS = {
    "b0": [(1, 16, 1, 1, 3, True), (4, 32, 2, 2, 3, True),
           (4, 48, 2, 2, 3, True), (4, 96, 3, 2, 3, False),
           (6, 112, 5, 1, 3, False), (6, 192, 8, 2, 3, False)],
    "b3": [(1, 16, 2, 1, 3, True), (4, 40, 3, 2, 3, True),
           (4, 56, 3, 2, 3, True), (4, 112, 5, 2, 3, False),
           (6, 136, 7, 1, 3, False), (6, 232, 12, 2, 3, False)],
    "s": [(1, 24, 2, 1, 3, True), (4, 48, 4, 2, 3, True),
          (4, 64, 4, 2, 3, True), (4, 128, 6, 2, 3, False),
          (6, 160, 9, 1, 3, False), (6, 256, 15, 2, 3, False)],
    "m": [(1, 24, 3, 1, 3, True), (4, 48, 5, 2, 3, True),
          (4, 80, 5, 2, 3, True), (4, 160, 7, 2, 3, False),
          (6, 176, 14, 1, 3, False), (6, 304, 18, 2, 3, False),
          (6, 512, 5, 1, 3, False)],
}
EFFICIENTNET_V2_STEM = {"b0": 32, "b3": 40, "s": 24, "m": 24}
EFFICIENTNET_V2_HEAD = {"b0": 1280, "b3": 1536, "s": 1280, "m": 1280}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_VAR = (0.229**2, 0.224**2, 0.225**2)

# EfficientNet blocks run, by kind, and squeeze-excite gates applied
register_counters("efficientnet", ("fused", "mbconv", "se"))


def _cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


# ---------------------------------------------------------------------------
# ResNet v1 / v2
# ---------------------------------------------------------------------------


class BottleneckV1(nn.Module):
    """keras.applications residual_block_v1: 1x1 (stride here) / 3x3 / 1x1
    with a conv shortcut when ``project``, BN eps 1.001e-5, registered in
    the keras graph's order (1_conv, 1_bn, 2_conv, 2_bn, 0_conv, 3_conv,
    0_bn, 3_bn)."""

    flax_kind = "BottleneckV1"

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 project: bool = False, dtype=None, generator=None):
        super().__init__()
        f, s, eps = filters, (stride, stride), RESNET_BN_EPS
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        self.conv1 = conv(in_channels, f, (1, 1), stride=s)
        self.bn1 = KerasBatchNorm(f, eps=eps)
        self.conv2 = conv(f, f, (3, 3))
        self.bn2 = KerasBatchNorm(f, eps=eps)
        self.short = conv(in_channels, 4 * f, (1, 1), stride=s) if project else None
        self.conv3 = conv(f, 4 * f, (1, 1))
        self.short_bn = KerasBatchNorm(4 * f, eps=eps) if project else None
        self.bn3 = KerasBatchNorm(4 * f, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        shortcut = x if self.short is None else self.short_bn(self.short(x))
        return F.relu(self.bn3(self.conv3(y)) + shortcut)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck (ResNet50V2), BN eps 1e-3; the stride on
    the 3x3."""

    flax_kind = "BottleneckV2"

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 project: bool = False, dtype=None, generator=None):
        super().__init__()
        f, s = filters, (stride, stride)
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        self.pre_bn = KerasBatchNorm(in_channels)
        self.short = conv(in_channels, 4 * f, (1, 1), stride=s) if project else None
        self.conv1 = conv(in_channels, f, (1, 1))
        self.bn1 = KerasBatchNorm(f)
        self.conv2 = conv(f, f, (3, 3), stride=s)
        self.bn2 = KerasBatchNorm(f)
        self.conv3 = conv(f, 4 * f, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.pre_bn(x))
        shortcut = x if self.short is None else self.short(pre)
        y = F.relu(self.bn1(self.conv1(pre)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self.conv3(y) + shortcut


class ResNet(nn.Module):
    """Headless ResNet; ``stage_sizes`` (3,4,6,3) = 50, (3,8,36,3) = 152;
    ``v2`` uses pre-activation blocks.  Keras stem: ZeroPadding 3 + VALID
    7x7/2, then ZeroPadding 1 + VALID 3x3/2 max pool."""

    flax_kind = "ResNet"
    out_channels = 2048

    def __init__(self, in_channels: int = 3, stage_sizes=(3, 4, 6, 3),
                 v2: bool = False, dtype=None, generator=None):
        super().__init__()
        self.dtype, self.v2 = dtype, v2
        self.stem = Conv(in_channels, 64, (7, 7), stride=(2, 2), dtype=dtype,
                         generator=generator)
        self.stem_bn = None if v2 else KerasBatchNorm(64, eps=RESNET_BN_EPS)
        block = BottleneckV2 if v2 else BottleneckV1
        blocks, width = [], 64
        for stage, n_blocks in enumerate(stage_sizes):
            f = 64 * 2**stage
            for b in range(n_blocks):
                blocks.append(block(width, f, 2 if b == 0 and stage > 0 else 1,
                                    b == 0, dtype=dtype, generator=generator))
                width = 4 * f
        self.blocks = nn.ModuleList(blocks)
        self.post_bn = KerasBatchNorm(width, eps=RESNET_BN_EPS) if v2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(zero_pad(_cast(x, self.dtype), 3))
        if self.stem_bn is not None:
            x = F.relu(self.stem_bn(x))
        x = F.max_pool2d(zero_pad(x, 1), 3, 2)
        for block in self.blocks:
            x = block(x)
        return x if self.post_bn is None else F.relu(self.post_bn(x))


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------


class VGG(nn.Module):
    """Headless VGG16 (blocks 2,2,3,3,3) / VGG19 (2,2,4,4,4) conv trunk."""

    flax_kind = "VGG"
    out_channels = 512

    def __init__(self, in_channels: int = 3, blocks=(2, 2, 3, 3, 3),
                 dtype=None, generator=None):
        super().__init__()
        self.dtype, self.blocks = dtype, tuple(blocks)
        convs, width = [], in_channels
        for w, n in zip((64, 128, 256, 512, 512), blocks):
            for _ in range(n):
                convs.append(Conv(width, w, (3, 3), padding="SAME",
                                  dtype=dtype, generator=generator))
                width = w
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, convs = _cast(x, self.dtype), iter(self.convs)
        for n in self.blocks:
            for _ in range(n):
                x = F.relu(next(convs)(x))
            x = max_pool(x, (2, 2))
        return x


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------


class InvertedResidual(nn.Module):
    """1x1 expand (when ``expand`` != 1) -> BN -> ReLU6 -> 3x3 depthwise
    (stride ``stride``) -> BN -> ReLU6 -> 1x1 project -> BN, plus the input
    when the stride is 1 and the width is kept.  The depthwise conv is
    Flax's plain ``nn.Conv`` with a bias and its default lecun-normal init
    (JAX ``backbones.py:188-190``; Keras' has no bias)."""

    flax_kind = "InvertedResidual"

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
                              groups=hidden, raw=True)
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

    flax_kind = "MobileNetV2"
    out_channels = 1280

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
        x = relu6(self.stem_bn(self.stem(_cast(x, self.dtype))))
        for block in self.blocks:
            x = block(x)
        return relu6(self.head_bn(self.head(x)))


# ---------------------------------------------------------------------------
# DenseNet121
# ---------------------------------------------------------------------------


class _DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 conv (4 growth) -> BN -> ReLU -> 3x3 conv
    (growth), concatenated to the input.  Its layers number in the
    DenseNet's own scope (no ``flax_kind``)."""

    def __init__(self, width: int, growth: int, dtype, generator):
        super().__init__()
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        self.bn1 = KerasBatchNorm(width, eps=RESNET_BN_EPS)
        self.conv1 = conv(width, 4 * growth, (1, 1))
        self.bn2 = KerasBatchNorm(4 * growth, eps=RESNET_BN_EPS)
        self.conv2 = conv(4 * growth, growth, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], 1)


class _Transition(nn.Module):
    """BN -> ReLU -> 1x1 conv to half the width -> 2x2 average pool."""

    def __init__(self, width: int, dtype, generator):
        super().__init__()
        self.bn = KerasBatchNorm(width, eps=RESNET_BN_EPS)
        self.conv = Conv(width, width // 2, (1, 1), padding="SAME",
                         dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class DenseNet(nn.Module):
    """keras.applications DenseNet: explicit (3,3) / (1,1) stem pads with
    VALID conv / pool and BN eps 1.001e-5 throughout."""

    flax_kind = "DenseNet"

    def __init__(self, in_channels: int = 3, blocks=(6, 12, 24, 16),
                 growth: int = 32, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(in_channels, 64, (7, 7), stride=(2, 2), dtype=dtype,
                         generator=generator)
        self.stem_bn = KerasBatchNorm(64, eps=RESNET_BN_EPS)
        layers, width = [], 64
        for bi, n in enumerate(blocks):
            for _ in range(n):
                layers.append(_DenseLayer(width, growth, dtype, generator))
                width += growth
            if bi != len(blocks) - 1:
                layers.append(_Transition(width, dtype, generator))
                width //= 2
        self.layers = nn.ModuleList(layers)
        self.final_bn = KerasBatchNorm(width, eps=RESNET_BN_EPS)
        self.out_channels = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(zero_pad(_cast(x, self.dtype), 3))
        x = F.max_pool2d(zero_pad(F.relu(self.stem_bn(x)), 1), 3, 2)
        for layer in self.layers:
            x = layer(x)
        return F.relu(self.final_bn(x))


# ---------------------------------------------------------------------------
# EfficientNet B / V2
# ---------------------------------------------------------------------------


class SqueezeExcite(nn.Module):
    """Spatial mean -> 1x1 conv to ``reduce_ch`` -> SiLU -> 1x1 conv back
    -> sigmoid gate on the input."""

    flax_kind = "SqueezeExcite"

    def __init__(self, channels: int, reduce_ch: int, dtype=None,
                 generator=None):
        super().__init__()
        self.reduce = Conv(channels, reduce_ch, (1, 1), padding="SAME",
                           dtype=dtype, generator=generator)
        self.expand = Conv(reduce_ch, channels, (1, 1), padding="SAME",
                           dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("efficientnet", "se")
        return region("cnn.se", self._gate, x)

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = self.expand(silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Mobile inverted bottleneck (JAX ``backbones.py:286-335``), SiLU.

    * depthwise (``fused=False``): 1x1 expand (when ``expand`` != 1) -> BN
      -> kxk depthwise, stride here (Flax's raw ``nn.Conv``) -> BN ->
      squeeze-excite on ``max(1, int(in * se_ratio))`` of the block's INPUT
      width -> 1x1 project -> BN;
    * fused: kxk strided expand conv -> BN, then the 1x1 project -> BN, no
      SE;
    * fused with ``expand == 1``: one kxk strided conv straight to
      ``filters`` -> BN -> SiLU, no project.

    The input is added back when the stride is 1 and the width is kept.
    Each conv with its BatchNorm, SiLU and that residual is one
    ``layers.conv_bn``: in eval on the card the bias-free conv and one
    epilogue kernel."""

    flax_kind = "MBConv"

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, expand: int = 6, se_ratio: float = 0.25,
                 fused: bool = False, dtype=None, generator=None):
        super().__init__()
        mid, k, s = in_channels * expand, (kernel, kernel), (stride, stride)
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        self.residual = stride == 1 and in_channels == filters
        self.expand = self.expand_bn = self.depthwise = None
        self.depthwise_bn = self.se = self.project = self.project_bn = None
        if fused:
            width = filters if expand == 1 else mid
            self.expand = conv(in_channels, width, k, stride=s)
            self.expand_bn = KerasBatchNorm(width)
        else:
            if expand != 1:
                self.expand = conv(in_channels, mid, (1, 1))
                self.expand_bn = KerasBatchNorm(mid)
            self.depthwise = conv(mid, mid, k, "lecun_normal", stride=s,
                                  groups=mid, raw=True)
            self.depthwise_bn = KerasBatchNorm(mid)
            if se_ratio:
                self.se = SqueezeExcite(
                    mid, max(1, int(in_channels * se_ratio)), dtype=dtype,
                    generator=generator)
        if not (fused and expand == 1):
            self.project = conv(mid, filters, (1, 1))
            self.project_bn = KerasBatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("efficientnet", "fused" if self.depthwise is None else "mbconv")
        res = x if self.residual else None
        y = x
        if self.expand is not None:
            y = conv_bn(self.expand, self.expand_bn, y, "silu",
                        residual=res if self.project is None else None)
        if self.depthwise is not None:
            y = conv_bn(self.depthwise, self.depthwise_bn, y, "silu")
        if self.se is not None:
            y = self.se(y)
        if self.project is not None:
            y = conv_bn(self.project, self.project_bn, y, residual=res)
        return y


def _round_filters(f: int, width: float) -> int:
    f = f * width
    new_f = max(8, int(f + 4) // 8 * 8)
    if new_f < 0.9 * f:
        new_f += 8
    return int(new_f)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(r * depth))


def _taps(size: int, kernel: int, stride: int, lo: int,
          like: torch.Tensor) -> torch.Tensor:
    """(outputs, kernel) of a SAME-padded conv along one axis, ``lo`` the
    padding before the input: 1 where a tap reads the input, 0 where it
    reads the padding."""
    at = (torch.arange(-(-size // stride), device=like.device)[:, None]
          * stride + torch.arange(kernel, device=like.device) - lo)
    return ((at >= 0) & (at < size)).to(like.dtype)


def _by_channel(w: torch.Tensor, values: tuple) -> list[torch.Tensor]:
    """``w[:, c] * values[c]`` for each input channel of the kernel ``w``
    (one value serves them all), by Python scalars: no constant tensor
    is copied to the card."""
    if len(values) == 1:
        values = values * w.shape[1]
    return [w[:, c] * v for c, v in enumerate(values)]


def folded_stem(x: torch.Tensor, conv: Conv, bn: KerasBatchNorm,
                scale: tuple, shift: tuple) -> torch.Tensor:
    """``bn(conv(x * scale + shift))``: the baked preprocessing affine
    (``scale`` and ``shift`` per input channel of the stem's kernel, or one
    of each for all), the SAME-padded stem conv and its BatchNorm, as the
    profiling region ``cnn.stem``.

    The affine maps the PCEN image's [-1, 1] to a narrow band (ImageNet's
    ``(x / 255 - 0.485) / 0.229`` to [-2.135, -2.101], ``x / 128 - 1`` to
    [-1.008, -0.992]), and the conv's output is a constant part about 123
    times the image's signal until the BatchNorm subtracts its running
    mean.  bf16 (steps of 2^-6 there) keeps 3 to 5 values of the band, TF32
    about 17.  So the affine is folded exactly into the conv: its kernel
    scaled by ``scale`` runs on the image itself, zero-padded, and the
    constant part, the bias plus ``shift`` times the taps that read the
    image and not the padding (padding the affine's output with zeros is
    padding ``x`` with ``-shift / scale``), is a (channels, H', W') map
    built in the parameters' dtype.  No tensor of the compute dtype ever
    holds the constant before the BatchNorm has taken it off: in eval mode
    the BatchNorm folds into the kernel and the map, which is then of the
    output's own order and is added to the conv's output in the compute
    dtype; in training the conv's output is widened to the parameters'
    dtype, the map added and the BatchNorm module (its region ``cnn.norm``
    inside ``cnn.stem``) run there before the cast back.  The fold runs the
    stem's conv in the compute dtype on the tensor cores, with no pass over
    the image, and keeps the image to the precision of the products, TF32
    included; running the affine, the conv and the BatchNorm in float32
    instead (with TF32 off for that conv) would write the stem's output in
    float32, 3.4 GB a 512-clip request at 160 x 513, and read it back.

    A 1-channel image against per-channel constants (EfficientNet's
    ``norm_mean`` broadcast to the kernel's 3 channels) takes the kernel
    summed over its channels.  Without a compute dtype the conv runs in
    the parameters' dtype, as Flax promotes."""
    return region("cnn.stem", partial(_stem, conv, bn, scale, shift), x,
                  conv.weight, conv.bias)


def _stem(conv, bn, scale, shift, x, w, b):
    kernel = torch.stack(_by_channel(w, scale), 1)
    if x.shape[1] != w.shape[1]:
        kernel = kernel.sum(1, keepdim=True)
    rows, cols = (
        _taps(size, k, s, same_pads(size, k, s)[0], w)
        for size, k, s in zip(x.shape[2:], conv.kernel, conv.stride))
    constant = sum(_by_channel(w, shift))  # (out, kh, kw)
    constant = b[:, None, None] + (
        (constant[:, None] * rows[:, :, None]).sum(2)[:, :, None]
        * cols).sum(-1)
    x = x.to(conv.dtype or w.dtype)
    if bn.training:
        y = conv._conv(x, kernel, None)
        return bn(y.to(w.dtype) + constant).to(y.dtype)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    constant = ((constant - bn.running_mean[:, None, None])
                * mul[:, None, None] + bn.bias[:, None, None])
    y = conv._conv(x, kernel * mul[:, None, None, None], None)
    return y + constant.to(y.dtype)


class EfficientNet(nn.Module):
    """EfficientNet-B* by compound scaling: (width, depth) B0 = (1.0, 1.0),
    B1 = (1.0, 1.1), B5 = (1.6, 2.2).  The keras graph's baked input
    preprocessing: ``rescale`` (x / 255), then ``(x - norm_mean) /
    sqrt(norm_var)`` and ``* extra_rescale`` when those per-channel
    constants are given (a weight import sets them; a 1-channel input
    broadcasts against them to their width, as in JAX).  The head's conv,
    BatchNorm and SiLU are one ``layers.conv_bn``."""

    flax_kind = "EfficientNet"

    def __init__(self, in_channels: int = 3, width: float = 1.0,
                 depth: float = 1.0, rescale: bool = True,
                 norm_mean: tuple = (), norm_var: tuple = (),
                 extra_rescale: tuple = (), dtype=None, generator=None):
        super().__init__()
        self.rescale = rescale
        self.norm_mean, self.norm_var = tuple(norm_mean), tuple(norm_var)
        self.extra_rescale = tuple(extra_rescale)
        stem_in = max([in_channels] + [len(c) for c in (
            self.norm_mean, self.extra_rescale) if c])
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        stem = _round_filters(32, width)
        self.stem = conv(stem_in, stem, (3, 3), stride=(2, 2))
        self.stem_bn = KerasBatchNorm(stem)
        blocks, ch = [], stem
        for t, c, n, s, k in EFFICIENTNET_SPEC:
            c = _round_filters(c, width)
            for i in range(_round_repeats(n, depth)):
                blocks.append(MBConv(ch, c, k, s if i == 0 else 1, t,
                                     dtype=dtype, generator=generator))
                ch = c
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = _round_filters(1280, width)
        self.head = conv(ch, self.out_channels, (1, 1))
        self.head_bn = KerasBatchNorm(self.out_channels)

    def preprocessing(self) -> tuple[tuple, tuple]:
        """(scale, shift) of the baked preprocessing ``x * scale + shift``,
        per channel where a constant is given."""
        scale = np.full(1, 1.0 / 255.0 if self.rescale else 1.0)
        shift = np.zeros(1)
        if self.norm_mean:
            std = np.sqrt(np.asarray(self.norm_var, np.float64))
            scale = scale / std
            shift = (shift - np.asarray(self.norm_mean, np.float64)) / std
        if self.extra_rescale:
            extra = np.asarray(self.extra_rescale, np.float64)
            scale, shift = scale * extra, shift * extra
        return tuple(scale.tolist()), tuple(shift.tolist())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = silu(folded_stem(x, self.stem, self.stem_bn,
                             *self.preprocessing()))
        for block in self.blocks:
            x = block(x)
        return conv_bn(self.head, self.head_bn, x, "silu")


class EfficientNetV2(nn.Module):
    """EfficientNetV2 with fused early stages, ``variant`` in b0, b3, s, m;
    B3 is 1536 wide at the head.  ``preprocess`` is keras'
    ``include_preprocessing``: the B variants on a 3-channel input apply
    x / 255 and the ImageNet mean and variance; every other input (and the
    S / M variants) ``x / 128 - 1``.  Training at ``channels=1`` takes the
    second branch, the 3-channel repeat the first.  The head's conv,
    BatchNorm and SiLU are one ``layers.conv_bn``."""

    flax_kind = "EfficientNetV2"

    def __init__(self, in_channels: int = 3, variant: str = "b0",
                 preprocess: bool = True, dtype=None, generator=None):
        super().__init__()
        self.variant, self.preprocess = variant, preprocess
        conv = partial(Conv, padding="SAME", dtype=dtype, generator=generator)
        stem = EFFICIENTNET_V2_STEM[variant]
        self.stem = conv(in_channels, stem, (3, 3), stride=(2, 2))
        self.stem_bn = KerasBatchNorm(stem)
        blocks, ch = [], stem
        for t, c, n, s, k, fused in EFFICIENTNET_V2_SPECS[variant]:
            for i in range(n):
                blocks.append(MBConv(ch, c, k, s if i == 0 else 1, t,
                                     fused=fused, dtype=dtype,
                                     generator=generator))
                ch = c
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = EFFICIENTNET_V2_HEAD[variant]
        self.head = conv(ch, self.out_channels, (1, 1))
        self.head_bn = KerasBatchNorm(self.out_channels)

    def preprocessing(self, channels: int) -> tuple[tuple, tuple]:
        """(scale, shift) of the baked preprocessing ``x * scale + shift``
        of a ``channels``-channel image."""
        if not self.preprocess:
            return (1.0,), (0.0,)
        if self.variant.startswith("b") and channels == 3:
            std = [math.sqrt(v) for v in IMAGENET_VAR]
            return (tuple(1.0 / (255.0 * s) for s in std),
                    tuple(-m / s for m, s in zip(IMAGENET_MEAN, std)))
        return (1.0 / 128.0,), (-1.0,)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = silu(folded_stem(x, self.stem, self.stem_bn,
                             *self.preprocessing(x.shape[1])))
        for block in self.blocks:
            x = block(x)
        return conv_bn(self.head, self.head_bn, x, "silu")


# ---------------------------------------------------------------------------
# InceptionV3 / InceptionResNetV2
# ---------------------------------------------------------------------------


class _ConvBN(nn.Module):
    """Keras' ``conv2d_bn``: conv -> BN(scale=False, eps 1e-3) -> ReLU."""

    def __init__(self, in_channels: int, filters: int, kernel, stride=1,
                 padding: str = "SAME", dtype=None, generator=None):
        super().__init__()
        self.conv = Conv(in_channels, filters, kernel, padding=padding,
                         stride=(stride, stride), dtype=dtype,
                         generator=generator)
        self.bn = KerasBatchNorm(filters, use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _op(out: str, src: str, filters: int, kernel, stride: int = 1,
        padding: str = "SAME"):
    kernel = (kernel, kernel) if isinstance(kernel, int) else kernel
    return out, src, filters, kernel, stride, padding


class _Branches(nn.Module):
    """One Inception block's branches, built and run from one list of
    ``_op``s in Flax's creation order: each reads ``"x"`` (the block's
    input), ``"avg"`` (TF-SAME 3x3 average pool of it) or an earlier op's
    output; ``concat`` names the outputs joined on the channels, where
    ``"max"`` is the VALID 3x3/2 max pool of the input."""

    def __init__(self, in_channels: int, ops, concat, dtype, generator):
        super().__init__()
        self.ops, self.concat = ops, concat
        width = {"x": in_channels, "avg": in_channels, "max": in_channels}
        cbrs = []
        for out, src, f, k, s, pad in ops:
            cbrs.append(_ConvBN(width[src], f, k, s, pad, dtype, generator))
            width[out] = f
        self.cbrs = nn.ModuleList(cbrs)
        self.out_channels = sum(width[n] for n in concat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        env = {"x": x}
        if any(op[1] == "avg" for op in self.ops):
            env["avg"] = same_avg_pool3(x)
        if "max" in self.concat:
            env["max"] = F.max_pool2d(x, 3, 2)
        for (out, src, *_), cbr in zip(self.ops, self.cbrs):
            env[out] = cbr(env[src])
        return torch.cat([env[n] for n in self.concat], 1)


class _ResidualBranches(nn.Module):
    """Inception-ResNet block: branches -> biased 1x1 ``up`` conv (no BN)
    -> ``x + scale * up`` (keras' CustomScaleLayer) -> ReLU unless the
    last block."""

    def __init__(self, in_channels: int, ops, concat, scale: float,
                 relu: bool, dtype, generator):
        super().__init__()
        self.branches = _Branches(in_channels, ops, concat, dtype, generator)
        self.up = Conv(self.branches.out_channels, in_channels, (1, 1),
                       padding="SAME", dtype=dtype, generator=generator)
        self.scale, self.relu = scale, relu
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x + self.scale * self.up(self.branches(x))
        return F.relu(out) if self.relu else out


def _inception_stem(in_channels: int, dtype, generator) -> nn.ModuleList:
    """conv 32 3x3/2 V, 32 3x3 V, 64 3x3, [max pool], 80 1x1 V, 192 3x3 V,
    [max pool]."""
    spec = ((in_channels, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
            (32, 64, 3, 1, "SAME"), (64, 80, 1, 1, "VALID"),
            (80, 192, 3, 1, "VALID"))
    return nn.ModuleList(_ConvBN(i, f, (k, k), s, p, dtype, generator)
                         for i, f, k, s, p in spec)


def _run_stem(stem: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    x = stem[2](stem[1](stem[0](x)))
    x = F.max_pool2d(x, 3, 2)
    return F.max_pool2d(stem[4](stem[3](x)), 3, 2)


def _inception_v3_blocks():
    """(ops, concat) of InceptionV3's mixed0-10 (JAX backbones.py:527-581),
    each in the keras graph's topological order."""
    blocks = []
    for pf in (32, 64, 64):  # inception-A
        blocks.append(([_op("dbl", "x", 64, 1), _op("b5", "x", 48, 1),
                        _op("dbl", "dbl", 96, 3), _op("b1", "x", 64, 1),
                        _op("b5", "b5", 64, 5), _op("dbl", "dbl", 96, 3),
                        _op("pool", "avg", pf, 1)],
                       ("b1", "b5", "dbl", "pool")))
    blocks.append(([_op("dbl", "x", 64, 1), _op("dbl", "dbl", 96, 3),
                    _op("b3", "x", 384, 3, 2, "VALID"),
                    _op("dbl", "dbl", 96, 3, 2, "VALID")],
                   ("b3", "dbl", "max")))
    for f in (128, 160, 160, 192):  # inception-B
        blocks.append(([_op("dbl", "x", f, 1), _op("dbl", "dbl", f, (7, 1)),
                        _op("b7", "x", f, 1), _op("dbl", "dbl", f, (1, 7)),
                        _op("b7", "b7", f, (1, 7)),
                        _op("dbl", "dbl", f, (7, 1)), _op("b1", "x", 192, 1),
                        _op("b7", "b7", 192, (7, 1)),
                        _op("dbl", "dbl", 192, (1, 7)),
                        _op("pool", "avg", 192, 1)],
                       ("b1", "b7", "dbl", "pool")))
    blocks.append(([_op("d", "x", 192, 1), _op("d", "d", 192, (1, 7)),
                    _op("b", "x", 192, 1), _op("d", "d", 192, (7, 1)),
                    _op("b", "b", 320, 3, 2, "VALID"),
                    _op("d", "d", 192, 3, 2, "VALID")], ("b", "d", "max")))
    for _ in range(2):  # inception-C
        blocks.append(([_op("dbl", "x", 448, 1), _op("b3", "x", 384, 1),
                        _op("dbl", "dbl", 384, 3),
                        _op("b3a", "b3", 384, (1, 3)),
                        _op("b3b", "b3", 384, (3, 1)),
                        _op("dbla", "dbl", 384, (1, 3)),
                        _op("dblb", "dbl", 384, (3, 1)),
                        _op("b1", "x", 320, 1), _op("pool", "avg", 192, 1)],
                       ("b1", "b3a", "b3b", "dbla", "dblb", "pool")))
    return blocks


class InceptionV3(nn.Module):
    """Headless keras.applications InceptionV3: every conv followed by
    BN(scale=False) + ReLU, average pools with TF's SAME denominator, each
    block in the keras graph's topological order (JAX
    ``backbones.py:486-582``)."""

    flax_kind = "InceptionV3"
    out_channels = 2048

    def __init__(self, in_channels: int = 3, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.stem = _inception_stem(in_channels, dtype, generator)
        blocks, width = [], 192
        for ops, concat in _inception_v3_blocks():
            blocks.append(_Branches(width, ops, concat, dtype, generator))
            width = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_stem(self.stem, _cast(x, self.dtype))
        for block in self.blocks:
            x = block(x)
        return x


class InceptionResNetV2(nn.Module):
    """Headless keras.applications InceptionResNetV2 (JAX
    ``backbones.py:585-683``): mixed_5b, 10 block35 at scale 0.17,
    mixed_6a, 20 block17 at 0.1, mixed_7a, 9 block8 at 0.2 and a last one
    at 1.0 without ReLU, conv_7b (1536)."""

    flax_kind = "InceptionResNetV2"
    out_channels = 1536

    def __init__(self, in_channels: int = 3, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.stem = _inception_stem(in_channels, dtype, generator)
        blocks = []

        def branches(width, ops, concat):
            blocks.append(_Branches(width, ops, concat, dtype, generator))
            return blocks[-1].out_channels

        def residual(width, ops, concat, scale, relu=True):
            blocks.append(_ResidualBranches(width, ops, concat, scale, relu,
                                            dtype, generator))

        width = branches(192, [
            _op("dbl", "x", 64, 1), _op("b5", "x", 48, 1),
            _op("dbl", "dbl", 96, 3), _op("b0", "x", 96, 1),
            _op("b5", "b5", 64, 5), _op("dbl", "dbl", 96, 3),
            _op("pool", "avg", 64, 1)], ("b0", "b5", "dbl", "pool"))
        for _ in range(10):
            residual(width, [
                _op("b2", "x", 32, 1), _op("b1", "x", 32, 1),
                _op("b2", "b2", 48, 3), _op("b0", "x", 32, 1),
                _op("b1", "b1", 32, 3), _op("b2", "b2", 64, 3)],
                ("b0", "b1", "b2"), 0.17)
        width = branches(width, [
            _op("b1", "x", 256, 1), _op("b1", "b1", 256, 3),
            _op("b0", "x", 384, 3, 2, "VALID"),
            _op("b1", "b1", 384, 3, 2, "VALID")], ("b0", "b1", "max"))
        for _ in range(20):
            residual(width, [
                _op("b1", "x", 128, 1), _op("b1", "b1", 160, (1, 7)),
                _op("b0", "x", 192, 1), _op("b1", "b1", 192, (7, 1))],
                ("b0", "b1"), 0.1)
        width = branches(width, [
            _op("b2", "x", 256, 1), _op("b0", "x", 256, 1),
            _op("b1", "x", 256, 1), _op("b2", "b2", 288, 3),
            _op("b0", "b0", 384, 3, 2, "VALID"),
            _op("b1", "b1", 288, 3, 2, "VALID"),
            _op("b2", "b2", 320, 3, 2, "VALID")], ("b0", "b1", "b2", "max"))
        for i in range(10):
            residual(width, [
                _op("b1", "x", 192, 1), _op("b1", "b1", 224, (1, 3)),
                _op("b0", "x", 192, 1), _op("b1", "b1", 256, (3, 1))],
                ("b0", "b1"), 1.0 if i == 9 else 0.2, relu=i < 9)
        self.blocks = nn.ModuleList(blocks)
        self.head = _ConvBN(width, 1536, (1, 1), dtype=dtype,
                            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_stem(self.stem, _cast(x, self.dtype))
        for block in self.blocks:
            x = block(x)
        return self.head(x)


# name -> constructor (in_channels, dtype=, generator=, **backbone_args),
# JAX backbones.py:687-704
BACKBONES = {
    "resnet": partial(ResNet, stage_sizes=(3, 4, 6, 3)),
    "resnetv2": partial(ResNet, stage_sizes=(3, 4, 6, 3), v2=True),
    "resnet152": partial(ResNet, stage_sizes=(3, 8, 36, 3)),
    "vgg16": partial(VGG, blocks=(2, 2, 3, 3, 3)),
    "vgg19": partial(VGG, blocks=(2, 2, 4, 4, 4)),
    "mobilenet": MobileNetV2,
    "densenet121": partial(DenseNet, blocks=(6, 12, 24, 16)),
    "efficientnetb0": partial(EfficientNet, width=1.0, depth=1.0),
    "efficientnetb1": partial(EfficientNet, width=1.0, depth=1.1),
    "efficientnetb5": partial(EfficientNet, width=1.6, depth=2.2),
    "efficientnetv2b0": partial(EfficientNetV2, variant="b0"),
    "efficientnetv2b3": partial(EfficientNetV2, variant="b3"),
    "efficientnetv2bs": partial(EfficientNetV2, variant="s"),
    "efficientnetv2bm": partial(EfficientNetV2, variant="m"),
    "inceptionv3": InceptionV3,
    "inceptionresnetv2": InceptionResNetV2,
}
