"""Train-mode BatchNorm: the CUDA kernels ``csrc/batch_norm.cu`` behind one
``torch.autograd.Function``.

``models/layers.py::KerasBatchNorm`` in training mode on a CUDA tensor calls
:func:`train_batch_norm`; on a CPU tensor it keeps its plain version (the
batch's f32 moments, Flax's fast variance clamped at 0, the running update
``0.99 running + 0.01 batch``, ``(x - mean) * (rstd * weight) + bias``).
The kernels compute the same function in four streaming passes (see the
source): the statistics and the apply forward, two gradient sums and the
apply backward, each tensor in its own dtype with f32 arithmetic in
registers, and save ``x`` as it is with the per-channel mean and rstd.

The layout is read from the input's strides (:func:`layout`): the input is
an ``(outer, C, inner)`` view of a dense tensor, channels innermost
(``inner == 1``: a channels-last conv output) or in the middle (the
per-mel-row BN's ``(B, 1, 160, 513)`` at ``feature_dim=2``, an
NCHW-contiguous tensor).  bf16 and f32 only; any other dtype, a tensor that
is not dense, or f32 parameters and statistics missing raise.  There is no
fallback to the plain version on the card.

Under an entered data-parallel mesh the per-channel ``[sum x, sum x^2]``
and the row count go through one f32 all-reduce before the statistics, and
the backward all-reduces ``[sum dy, sum dy (x - mean)]`` before ``dx``, as
the plain version's ``all_reduce_sum`` does forward and backward; the
parameter gradients stay this rank's sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.parallel.collectives import all_reduce_sum_
from audio_training_tpu_torch.utils import profiling

THREADS = 256  # csrc/batch_norm.cu's block
ROWS_PER_THREAD = 16  # rows a thread walks at least, where there are enough
BLOCKS_PER_SM = 4  # the grid's cap
CHUNK_MAX = 64  # csrc/batch_norm.cu's: rows a middle-layout apply block takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last reset, counted where they launch.
COUNTERS = ["statistics", "statistics_finalize", "apply", "backward_reduce",
            "backward_finalize", "backward_apply"]
profiling.register_counters("batch_norm", COUNTERS)


def launch_counts() -> dict[str, int]:
    return profiling.counts("batch_norm")


def reset_launch_counts() -> None:
    profiling.reset_counts("batch_norm")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("batch_norm")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.bn_reduce.argtypes = [i32, i32, i32, ptr, ptr, ptr, i64, i32, i64,
                              i32, ptr, ptr]
    lib.bn_finalize.argtypes = [ptr, i32, i32, i32, f32, ptr, f32, f32, f32,
                                ptr, ptr, ptr, ptr, ptr]
    lib.bn_finalize_backward.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr,
                                         ptr]
    lib.bn_apply.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                             i32, i64, i32, i32, ptr, ptr]
    for fn in (lib.bn_reduce, lib.bn_finalize, lib.bn_finalize_backward,
               lib.bn_apply):
        fn.restype = i32
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layout(shape, strides, feature_dim: int) -> tuple[int, int, int]:
    """``(outer, C, inner)`` such that element ``(o, c, i)`` of the tensor
    lies at ``(o * C + c) * inner + i`` from its first, for a dense tensor
    (its elements fill ``numel`` consecutive places in some order of its
    dims) with the feature dim ``feature_dim``; raises ValueError for any
    other tensor.  Dims of size 1 have no place in memory and are left
    out."""
    c = shape[feature_dim]
    order = sorted((d for d, n in enumerate(shape) if n > 1),
                   key=lambda d: -strides[d])
    expected = 1
    for d in reversed(order):
        if strides[d] != expected:
            raise ValueError(
                f"the BatchNorm kernels take a dense tensor: shape "
                f"{tuple(shape)} with strides {tuple(strides)} is not one")
        expected *= shape[d]
    if c == 1:
        return math.prod(shape), 1, 1
    at = order.index(feature_dim)
    return (math.prod(shape[d] for d in order[:at]), c,
            math.prod(shape[d] for d in order[at + 1:]))


class Plan(NamedTuple):
    """A launch plan: the ``(outer, C, inner)`` view, ``vec`` elements a
    thread loads at once in the rows layout (``inner == 1``), ``partials``
    a channel gets from the reduce (the rows layout's grid, the middle
    layout's splits of ``outer``), the apply's grid and the rows of
    ``inner`` a middle-layout apply block takes at a time (``chunk``, 1 in
    the rows layout)."""
    outer: int
    channels: int
    inner: int
    vec: int
    partials: int
    grid: int
    chunk: int


def plan(shape, strides, feature_dim: int, element_size: int,
         aligned: bool, sms: int) -> Plan:
    """The launch plan of an input of ``shape`` / ``strides`` whose
    elements take ``element_size`` bytes, its data 16-byte ``aligned`` or
    not, on a card of ``sms`` SMs."""
    outer, c, inner = layout(shape, strides, feature_dim)
    cap = BLOCKS_PER_SM * sms
    if inner == 1:
        wide = 16 // element_size
        vec = wide if aligned and c % wide == 0 else 1
        per = THREADS // min(c // vec, THREADS)  # rows a block-step
        grid = max(1, min(cap, -(-outer // (per * ROWS_PER_THREAD))))
        return Plan(outer, c, inner, vec, grid, grid, 1)
    splits = max(1, min(outer, -(-cap // c)))
    chunk = max(1, min(CHUNK_MAX, -(-THREADS * ROWS_PER_THREAD // inner)))
    grid = max(1, min(cap, -(-outer * c // chunk)))
    return Plan(outer, c, inner, 1, splits, grid, chunk)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"batch_norm {what} launch failed: cudaError {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` lies in memory as ``b`` does (the same strides on
    every dim of more than one element) and as aligned to 16 bytes."""
    return (a.data_ptr() % 16 == b.data_ptr() % 16
            and all(a.stride(d) == b.stride(d)
                    for d, n in enumerate(b.shape) if n > 1))


def _check_inputs(x, feature_dim, weight, bias, running_mean,
                  running_var) -> None:
    """Raise ValueError for what the kernels do not take, before any
    launch: the dtype, a tensor that is not dense, the parameters and
    statistics, then the device."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the BatchNorm kernels take bfloat16 or float32 "
                         f"activations, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("no BatchNorm kernel launch for an empty batch")
    layout(x.shape, x.stride(), feature_dim)
    c = x.shape[feature_dim]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (c,)
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(
                f"the BatchNorm kernels take a contiguous float32 {name} of "
                f"({c},) on {x.device}, got {tuple(t.shape)} {t.dtype} "
                f"{t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"no BatchNorm kernel for device {x.device}")


class _TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                feature_dim, eps, momentum, mesh):
        p = plan(x.shape, x.stride(), feature_dim, x.element_size(),
                 x.data_ptr() % 16 == 0, _sm_count(x.device.index))
        c, dtype, lib = p.channels, _DTYPES[x.dtype], _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        f32 = dict(dtype=torch.float32, device=x.device)
        partials = torch.empty(2 * c * p.partials, **f32)
        stats = torch.empty(3 * c + 1, **f32)
        y = torch.empty_like(x)
        count = float(x.numel() // c)
        keep, take = momentum, 1.0 - momentum
        with torch.cuda.device(x.device):
            _check(lib.bn_reduce(0, dtype, p.vec, x.data_ptr(), None, None,
                                 p.outer, c, p.inner, p.partials,
                                 partials.data_ptr(), stream), "statistics")
            profiling.count("batch_norm", "statistics")
            stat_args = (eps, keep, take, stats.data_ptr(),
                         running_mean.data_ptr(), running_var.data_ptr())
            if mesh is None:
                _check(lib.bn_finalize(partials.data_ptr(), p.partials, c, 0,
                                       count, None, *stat_args, None, stream),
                       "statistics finalize")
                profiling.count("batch_norm", "statistics_finalize")
            else:
                # [sum x, sum x^2, rows] over the ranks, then the statistics
                sums = torch.empty(2 * c + 1, **f32)
                _check(lib.bn_finalize(partials.data_ptr(), p.partials, c, 1,
                                       count, None, *stat_args,
                                       sums.data_ptr(), stream),
                       "statistics finalize")
                all_reduce_sum_(mesh, sums)
                _check(lib.bn_finalize(sums.data_ptr(), 1, c, 0, 0.0,
                                       sums.data_ptr() + 4 * 2 * c,
                                       *stat_args, None, stream),
                       "statistics finalize")
                profiling.count("batch_norm", "statistics_finalize")
                profiling.count("batch_norm", "statistics_finalize")
            _check(lib.bn_apply(0, dtype, p.vec, x.data_ptr(), None,
                                stats.data_ptr(), _ptr(weight), _ptr(bias),
                                None, p.outer, c, p.inner, p.grid, p.chunk,
                                y.data_ptr(), stream), "apply")
            profiling.count("batch_norm", "apply")
        ctx.save_for_backward(x, stats, weight)
        ctx.plan, ctx.mesh, ctx.has_bias = p, mesh, bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stats, weight = ctx.saved_tensors
        p, mesh = ctx.plan, ctx.mesh
        c, dtype, lib = p.channels, _DTYPES[x.dtype], _library()
        if not _same_layout(dy, x):
            dy = torch.empty_like(x).copy_(dy)  # the kernels read x's layout
        stream = torch.cuda.current_stream(x.device).cuda_stream
        f32 = dict(dtype=torch.float32, device=x.device)
        partials = torch.empty(2 * c * p.partials, **f32)
        sums = torch.empty(2 * c, **f32)
        want_w = weight is not None and ctx.needs_input_grad[1]
        want_b = ctx.has_bias and ctx.needs_input_grad[2]
        dweight = torch.empty(c, **f32) if want_w else None
        dbias = torch.empty(c, **f32) if want_b else None
        dx = None
        with torch.cuda.device(x.device):
            _check(lib.bn_reduce(1, dtype, p.vec, x.data_ptr(), dy.data_ptr(),
                                 stats.data_ptr(), p.outer, c, p.inner,
                                 p.partials, partials.data_ptr(), stream),
                   "backward reduce")
            profiling.count("batch_norm", "backward_reduce")
            _check(lib.bn_finalize_backward(
                partials.data_ptr(), p.partials, c, stats.data_ptr(),
                sums.data_ptr(), _ptr(dweight), _ptr(dbias), stream),
                "backward finalize")
            profiling.count("batch_norm", "backward_finalize")
            if ctx.needs_input_grad[0]:
                if mesh is not None:
                    all_reduce_sum_(mesh, sums)
                dx = torch.empty_like(x)
                _check(lib.bn_apply(1, dtype, p.vec, x.data_ptr(),
                                    dy.data_ptr(), stats.data_ptr(),
                                    _ptr(weight), None, sums.data_ptr(),
                                    p.outer, c, p.inner, p.grid, p.chunk,
                                    dx.data_ptr(), stream), "backward apply")
                profiling.count("batch_norm", "backward_apply")
        return dx, dweight, dbias, None, None, None, None, None, None


def train_batch_norm(x: torch.Tensor, feature_dim: int,
                     weight: torch.Tensor | None, bias: torch.Tensor | None,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     eps: float, momentum: float, mesh=None) -> torch.Tensor:
    """Train-mode BatchNorm of a CUDA tensor over every dim but
    ``feature_dim``: ``y`` in ``x``'s dtype and layout; ``running_mean`` and
    ``running_var`` updated in place to ``momentum * running + (1 -
    momentum) * batch``.  ``mesh``: the entered data-parallel mesh, whose
    global batch's moments are taken."""
    feature_dim %= x.ndim
    _check_inputs(x, feature_dim, weight, bias, running_mean, running_var)
    return _TrainBatchNorm.apply(x, weight, bias, running_mean, running_var,
                                 feature_dim, eps, momentum, mesh)
