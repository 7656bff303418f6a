"""Shared layers (port of ``audio_training_tpu/models/layers.py``).

Keras conventions, so logits match the Flax models on converted weights:
BatchNorm epsilon 1e-3 and momentum 0.99, convs VALID with glorot-uniform
kernels and zero bias unless told otherwise (``padding="SAME"`` is XLA's
split, which torch's symmetric ``padding=`` does not give), explicit
LeakyReLU slope.  Layers work on NCHW
tensors (H = mel, W = time); the models' public inputs keep the JAX NHWC
layout.

A compute ``dtype`` (e.g. ``torch.bfloat16``) casts activations and weights
at each conv while the parameters stay f32, as Flax's ``dtype`` does.

``_condense_conv``'s custom backward (JAX ``layers.py:39-89``) exists for
the TPU's dgrad emitter and is the same function as the plain conv's
gradient; here autograd (cuDNN on the card) computes it, held against the
JAX custom VJP by tests/test_torch_train_step.py.

``Conv`` and ``KerasBatchNorm`` run as the profiling regions ``cnn.conv``
(``cnn.depthwise`` for a grouped conv) and ``cnn.norm``
(``utils/profiling.region``), :func:`silu` as ``cnn.act``: spans of their
forward and backward while a profiler records, a plain call otherwise.

:func:`conv_bn` runs a conv, its BatchNorm, the activation and the residual
of a block.  Where it can tell that nothing needs the parts (an eval-mode
BatchNorm, a CUDA tensor, no gradient recorded), the conv runs without its
bias in ``cnn.conv`` / ``cnn.depthwise`` and one kernel
(``ops/cuda/conv_epilogue.py``, which raises for a dtype or parameter it
does not take) applies the bias, the BatchNorm, the activation and the
residual in ``cnn.norm``; the activation's ``cnn.act`` then holds nothing
of the block.  Every other call is the modules' composition, counted
``plain`` in the counter group ``conv_epilogue`` beside the kernel's
launches.

Each layer that holds Flax variables names its Flax kind (``flax_kind``,
the Flax class name that numbers its scope) and its leaves
(``flax_leaves``: collection, path below the scope, torch tensor, layout
change); ``models/convert.py`` walks a model by these.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audio_training_tpu_torch.ops.cuda import conv_epilogue
from audio_training_tpu_torch.ops.cuda.batch_norm import train_batch_norm
from audio_training_tpu_torch.ops.features import mag_transform
from audio_training_tpu_torch.ops.pcen import pcen
from audio_training_tpu_torch.parallel.collectives import all_reduce_sum
from audio_training_tpu_torch.parallel.mesh import active_mesh, local_rows
from audio_training_tpu_torch.utils.profiling import count, region

# Keras BatchNormalization defaults
BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, alpha)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the profiling region ``cnn.act``."""
    return region("cnn.act", F.silu, x)


def hwio_to_oihw(a: torch.Tensor) -> torch.Tensor:
    """A Flax conv kernel (H, W, I, O) as a torch conv weight (O, I, H, W)."""
    return a.permute(3, 2, 0, 1)


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate), the mask drawn from ``generator``; the identity in eval
    or at rate 0.  Under an entered data-parallel mesh ``x`` is this rank's
    rows of the batch (dim 0): the mask is drawn for the global batch and
    this rank's rows taken, as JAX's SPMD draws one key's mask for the
    sharded global array, so with the generator seeded alike on every rank
    the masks are the single-device run's (the bits still differ from
    JAX's: parity tests run at rate 0)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    n, rows = local_rows(x.shape[0])
    mask = torch.empty((n, *x.shape[1:]), device=x.device).bernoulli_(
        keep, generator=generator)[rows]
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``ceil(size / stride)``
    outputs, the total pad split ``lo = total // 2``, ``hi = total - lo``
    (for the stride-2 3x3 stem at 160 x 513: (0, 1) on mel, (1, 1) on
    time)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class KerasBatchNorm(nn.Module):
    """BatchNorm with Keras defaults (Flax ``nn.BatchNorm`` as
    ``KerasBatchNorm`` configures it, JAX ``layers.py:121-143``).

    ``feature_dim=1`` is the usual channels BN of an NCHW tensor;
    ``feature_dim=2`` with no scale and no bias is badwinner2's per-mel-row
    BN (``BatchNormalization(axis=1)`` on NHWC, badwinner2.py:66-67), whose
    statistics reduce over every axis but mel.  Normalization runs in f32
    and the result has the input's dtype, as Flax's BatchNorm gives it in
    both badwinner2 uses.

    Training mode normalizes by the batch's own moments and updates the
    running statistics as Flax does, NOT as ``F.batch_norm`` would: the
    moments are computed in f32 (Flax reduces bf16 inputs in f32), the
    variance is the biased one, ``E[x^2] - E[x]^2`` clamped at 0 (Flax's
    fast variance; ``F.batch_norm`` stores the unbiased variance), and
    ``running = 0.99 running + 0.01 batch``.  ``eps`` is Keras' 1e-3 unless
    given (keras.applications' ResNets and DenseNet pass 1.001e-5).

    Under an entered data-parallel mesh (``parallel.mesh``) the moments are
    the global batch's, as JAX's SPMD computes them: the per-channel sums
    of ``x`` and ``x^2`` and the row count are all-reduced in f32, in one
    call whose backward all-reduces the gradient (``SyncBatchNorm`` keeps
    PyTorch's unbiased running variance and momentum, not Flax's rule).

    Training mode on a CUDA tensor runs the hand-written kernels of
    ``ops/cuda/batch_norm.py`` (bf16 or f32, dense layouts; anything else
    raises); :meth:`train_plain` is their plain version, which training on
    a CPU tensor takes.  Eval mode is ``F.batch_norm`` (``feature_dim=1``)
    or :meth:`_affine`.
    """

    flax_kind = "KerasBatchNorm"

    def __init__(self, num_features: int, feature_dim: int = 1,
                 use_scale: bool = True, use_bias: bool = True,
                 eps: float = BN_EPS):
        super().__init__()
        self.feature_dim = feature_dim
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None

    def flax_leaves(self):
        leaves = [("batch_stats", ("BatchNorm_0", "mean"), "running_mean"),
                  ("batch_stats", ("BatchNorm_0", "var"), "running_var")]
        if self.weight is not None:
            leaves.append(("params", ("BatchNorm_0", "scale"), "weight"))
        if self.bias is not None:
            leaves.append(("params", ("BatchNorm_0", "bias"), "bias"))
        return [(c, p, t, _identity) for c, p, t in leaves]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def _affine(self, x, mean, var, shape, weight, bias):
        mul = torch.rsqrt(var + self.eps)
        if weight is not None:
            mul = mul * weight
        y = (x - mean.view(shape)) * mul.view(shape)
        if bias is not None:
            y = y + bias.view(shape)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return region("cnn.norm", self._norm, x, self.weight, self.bias)

    def _norm(self, x, weight, bias):
        if self.training:
            if x.device.type == "cuda":
                return train_batch_norm(x, self.feature_dim, weight, bias,
                                        self.running_mean, self.running_var,
                                        self.eps, BN_MOMENTUM, active_mesh())
            return self.train_plain(x, weight, bias)
        if self.feature_dim == 1:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        shape = [1] * x.ndim
        shape[self.feature_dim] = -1
        return self._affine(x, self.running_mean, self.running_var, shape,
                            weight, bias)

    def train_plain(self, x, weight, bias):
        """The plain version of the training kernels, on any device: the
        batch's moments, the running update and the affine, as autograd
        ops in f32 (f64 for an f64 input)."""
        shape = [1] * x.ndim
        shape[self.feature_dim] = -1
        dims = [d for d in range(x.ndim) if d != self.feature_dim]
        xf = x if x.dtype == torch.float64 else x.float()
        mesh = active_mesh()
        if mesh is None:
            mean = xf.mean(dims)
            ex2 = (xf * xf).mean(dims)
        else:
            # the global batch's moments: [sum x, sum x^2, rows] in one
            # all-reduce that carries the gradient
            c = xf.shape[self.feature_dim]
            rows = torch.full((1,), xf.numel() / c, dtype=xf.dtype,
                              device=xf.device)
            sums = all_reduce_sum(mesh, torch.cat(
                [xf.sum(dims), (xf * xf).sum(dims), rows]))
            mean, ex2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = (ex2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1.0 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1.0 - BN_MOMENTUM) * var)
        return self._affine(xf, mean, var, shape, weight, bias).to(x.dtype)


class MagTransform(nn.Module):
    """Trainable magnitude compression ``x**sigmoid(a)`` with ``a`` clipped
    to [-2, 1] (badwinner2.MagTransform, badwinner2.py:32-49)."""

    flax_kind = "MagTransform"

    def __init__(self, init_value: float = -1.0):
        super().__init__()
        self.init_value = init_value
        self.a_power = nn.Parameter(torch.full((1,), init_value))

    def flax_leaves(self):
        return [("params", ("a_power",), "a_power", _identity)]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.a_power.fill_(self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mag_transform(x, self.a_power.clamp(-2.0, 1.0).to(x.dtype))


def logmeanexp(x: torch.Tensor, dim: int, sharpness: float = 5.0,
               keepdim: bool = True) -> torch.Tensor:
    """Log-mean-exp pooling (badwinner2.LMELayer, badwinner2.py:343-355)."""
    lse = torch.logsumexp(x * sharpness, dim=dim, keepdim=keepdim)
    return (lse - math.log(x.shape[dim])) / sharpness


class PCENLayer(nn.Module):
    """Trainable per-channel energy normalization (JAX ``layers.py:162-194``,
    tfpcen.PCEN): scalar ``gain``, ``bias``, ``root`` and ``smooth``
    parameters, the ``ops.pcen`` math (EMA over ``time_axis`` seeded with
    frame 0, gain clamped to <= 1, root to >= 1) and the global min-max to
    [-1, 1] over the whole batch."""

    flax_kind = "PCENLayer"

    def __init__(self, eps: float = 1e-6, time_axis: int = 1):
        super().__init__()
        self.eps = eps
        self.time_axis = time_axis
        self.gain = nn.Parameter(torch.full((1,), 0.98))
        self.bias = nn.Parameter(torch.full((1,), 2.0))
        self.root = nn.Parameter(torch.full((1,), 2.0))
        self.smooth = nn.Parameter(torch.full((1,), 0.04))

    def flax_leaves(self):
        return [("params", (n,), n, _identity)
                for n in ("gain", "bias", "root", "smooth")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pcen(x, self.gain, self.bias, self.root, self.smooth,
                    self.eps, time_axis=self.time_axis)


class LMELayer(nn.Module):
    """Log-mean-exp pooling over NCHW dim ``dim`` (2 = mel, 3 = time)."""

    def __init__(self, dim: int, sharpness: float = 5.0):
        super().__init__()
        self.dim = dim
        self.sharpness = sharpness

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logmeanexp(x, self.dim, self.sharpness)


def lecun_normal_(w: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's default kernel init: truncated normal (at 2 std), variance
    1 / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


class Conv(nn.Module):
    """Keras-style Conv2D on NCHW: VALID padding, stride 1, glorot-uniform
    kernel, zero bias by default; ``stride``, ``padding="SAME"`` (XLA's
    split, :func:`same_pads`, padded explicitly) and ``groups`` (a depthwise
    conv: ``groups = in_channels``) as Flax's ``nn.Conv`` takes them.
    ``init`` is ``"glorot"``, ``"orthogonal"`` or ``"lecun_normal"`` (Flax's
    ``nn.Conv`` default).  ``weight`` is OIHW.  The Flax ``Conv`` wrapper
    keeps its variables at ``Conv_k/Conv_0/{kernel,bias}``; ``raw=True`` is
    a Flax ``nn.Conv`` called directly (the depthwise convs), at
    ``Conv_k/{kernel,bias}``.  Both count as ``Conv``."""

    flax_kind = "Conv"

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], init: str = "glorot",
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None, *,
                 stride: Sequence[int] = (1, 1), padding: str = "VALID",
                 groups: int = 1, raw: bool = False):
        super().__init__()
        self.raw = raw
        if init not in ("glorot", "orthogonal", "lecun_normal"):
            raise ValueError(f"unknown init {init!r}")
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"unknown padding {padding!r}")
        self.dtype = dtype
        self.init = init
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters(generator)

    def flax_leaves(self):
        scope = () if self.raw else ("Conv_0",)
        return [("params", (*scope, "kernel"), "weight", hwio_to_oihw),
                ("params", (*scope, "bias"), "bias", _identity)]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if self.init == "glorot":
            nn.init.xavier_uniform_(self.weight, generator=generator)
        elif self.init == "orthogonal":
            nn.init.orthogonal_(self.weight, generator=generator)
        else:
            lecun_normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """The conv, with its bias or (``bias=False``) without, as the
        region ``cnn.depthwise`` (groups > 1) or ``cnn.conv``."""
        name = "cnn.depthwise" if self.groups > 1 else "cnn.conv"
        return region(name, self._conv, x, self.weight,
                      self.bias if bias else None)

    def _conv(self, x, w, b):
        """The conv of ``x`` by kernel ``w`` and bias ``b`` (None: none) in
        the compute dtype, SAME-padded as the layer is."""
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        pad = (0, 0)
        if self.padding == "SAME":
            # the symmetric part of XLA's split is conv2d's own zero pad;
            # only the extra row / column of an asymmetric split (a
            # stride-2 conv on an even size) is padded explicitly
            (h0, h1), (w0, w1) = (
                same_pads(size, k, s) for size, k, s in
                zip(x.shape[2:], self.kernel, self.stride))
            pad = (min(h0, h1), min(w0, w1))
            if h0 != h1 or w0 != w1:
                x = F.pad(x, (w0 - pad[1], w1 - pad[1], h0 - pad[0],
                              h1 - pad[0]))
        return F.conv2d(x, w, b, stride=self.stride, padding=pad,
                        groups=self.groups)


def _fusable(conv: Conv, bn: KerasBatchNorm, x: torch.Tensor,
             residual: torch.Tensor | None) -> bool:
    """Whether :func:`conv_bn` may hand the work after ``conv`` to the
    epilogue kernel, which has no backward: an eval-mode BatchNorm over
    dim 1, a CUDA input and no gradient recorded."""
    if bn.training or bn.feature_dim != 1 or not x.is_cuda:
        return False
    return not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad
        for t in (x, residual, conv.weight, conv.bias, bn.weight, bn.bias))


def conv_bn(conv: Conv, bn: KerasBatchNorm, x: torch.Tensor,
            act: str | None = None, alpha: float = 0.01,
            act_first: bool = False,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """A block's ``act(bn(conv(x)))`` (``bn(act(conv(x)))`` with
    ``act_first``), plus ``residual`` when given; ``act`` is None,
    ``"silu"`` (:func:`silu`) or ``"leaky_relu"`` of slope ``alpha``.

    Where :func:`_fusable` allows, the conv runs without its bias (region
    ``cnn.conv`` / ``cnn.depthwise``) and the epilogue kernel applies the
    bias, the BatchNorm's running-statistics affine, the activation and
    the residual in one pass in f32, rounded once (region ``cnn.norm``).
    Otherwise (training, CPU tensors, a recorded gradient): the modules'
    composition, as the models ran it before, counted ``plain``."""
    if _fusable(conv, bn, x, residual):
        y = conv(x, bias=False)
        return region("cnn.norm", conv_epilogue.eval_epilogue, y, conv.bias,
                      bn.running_mean, bn.running_var, bn.weight, bn.bias,
                      bn.eps, act, alpha, act_first, residual)
    count("conv_epilogue", "plain")
    fn = {None: _identity, "silu": silu,
          "leaky_relu": lambda t: leaky_relu(t, alpha)}[act]
    y = bn(fn(conv(x))) if act_first else fn(bn(conv(x)))
    return y if residual is None else y + residual


class Dense(nn.Module):
    """Flax ``nn.Dense`` on the last axis (a pointwise layer on a 4-D NHWC
    map, as Keras' Dense): lecun-normal kernel, zero bias, computed in
    ``dtype`` when given, else, as Flax promotes them, in the common type of
    the input and the parameters (a bf16 input to an f32 Dense computes in
    f32).  ``weight`` is (out, in); Flax's kernel is (in, out)."""

    flax_kind = "Dense"

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, generator=generator)
            self.bias.zero_()

    def flax_leaves(self):
        return [("params", ("kernel",), "weight", lambda a: a.T),
                ("params", ("bias",), "bias", _identity)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Keras MaxPool2D semantics: stride = window, valid padding."""
    return F.max_pool2d(x, tuple(window), tuple(window))


def zero_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad`` of the two spatial dims by ``pad`` zeros a side (Keras'
    ZeroPadding2D; a max pool after it sees the zeros, not -inf)."""
    return F.pad(x, (pad, pad, pad, pad))


def avg_pool(x: torch.Tensor, window: Sequence[int],
             padding: str = "VALID") -> torch.Tensor:
    """Flax ``nn.avg_pool`` with stride = window; ``"SAME"`` pads XLA's
    split with zeros that count in the denominator (Flax's
    ``count_include_pad=True``)."""
    window = tuple(window)
    if padding == "SAME":
        (h0, h1), (w0, w1) = (same_pads(n, k, k)
                              for n, k in zip(x.shape[2:], window))
        x = F.pad(x, (w0, w1, h0, h1))
    return F.avg_pool2d(x, window, window)


def same_avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """Keras ``AveragePooling2D((3, 3), strides=1, padding="same")`` with
    TF's denominator, the count of valid cells (JAX
    ``backbones._same_avg_pool3``)."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """GlobalAveragePooling2D over (H, W) of NCHW."""
    return x.mean(dim=(2, 3))
