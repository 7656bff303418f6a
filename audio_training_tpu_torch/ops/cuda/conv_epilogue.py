"""The eval-mode conv epilogue: the CUDA kernel ``bn_eval_epilogue`` of
``csrc/batch_norm.cu`` and its plain version.

After an eval-mode conv, :func:`models.layers.conv_bn` hands the conv's
bias-free output ``x`` to one pass that applies the conv's bias ``b``, the
BatchNorm's running-statistics affine ``s = weight * rsqrt(var + eps)``,
``t = bias - mean * s``, the activation and the residual ``r``, in f32,
rounded once to ``x``'s dtype:

* activation before the BatchNorm (badwinner2's blocks):
  ``act(x + b) * s + t + r``;
* after it (the EfficientNets'): ``act(x * s + (t + b * s)) + r``.

The activation is none, SiLU or LeakyReLU of a slope.  :func:`eval_epilogue`
launches the kernel; :func:`eval_epilogue_plain` is the same function as
tensor ops on any device (f64 arithmetic for an f64 input), which the tests
hold the kernel to.

The layout is read from ``x``'s strides as the train-mode kernels read it
(``batch_norm.layout``, the channel dim 1): channels innermost, walked flat
by a grid whose threads keep their channels from step to step (their
coefficients in registers), or channels in the middle.  Any channel count.
bf16 and f32 only; a tensor that is not dense, parameters that are not f32
vectors of the channels on ``x``'s device, or a residual of another shape
or dtype raise: these checks, made once a call, are the whole rule of what
the kernel takes.  A residual laid out otherwise than ``x`` is copied into
``x``'s layout first.

The counter group ``conv_epilogue`` counts each kernel's launches where
they return, ``rows`` and ``mid``, and ``plain``, the calls of
``layers.conv_bn`` that ran the modules' composition instead.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from audio_training_tpu_torch.ops.cuda.batch_norm import (
    CHUNK_MAX,
    THREADS,
    _sm_count,
    layout,
)
from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.utils import profiling

ACTS = {None: 0, "silu": 1, "leaky_relu": 2}  # csrc/batch_norm.cu's Act
BLOCKS_PER_SM = 8  # the grid's cap: a full SM's threads
VECTORS_PER_THREAD = 4  # the rows layout's grid: at least these a thread
ROWS_PER_THREAD = 16  # the middle layout's, as the train-mode apply's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

profiling.register_counters("conv_epilogue", ("rows", "mid", "plain"))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("batch_norm")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.bn_eval_epilogue.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr,
                                     ptr, ptr, ptr, f32, f32, i64, i32, i64,
                                     i32, i32, ptr, ptr]
    lib.bn_eval_epilogue.restype = i32
    return lib


def plan(shape, strides, element_size: int, aligned: bool,
         sms: int) -> tuple[tuple[int, int, int], int, int, int]:
    """The launch plan of a conv output of ``shape`` / ``strides`` (its
    elements ``element_size`` bytes, ``aligned`` to 16 bytes with the
    residual and the output or not) on a card of ``sms`` SMs:
    ``((outer, C, inner), vec, grid, chunk)``.  In the rows layout the
    grid is a multiple of ``m = groups / gcd(groups, THREADS)`` (``groups =
    C / vec``), so that its threads, a multiple of ``groups``, keep their
    channels from step to step: the most under the cap, or ``m``."""
    outer, c, inner = layout(shape, strides, 1)
    cap = BLOCKS_PER_SM * sms
    if inner == 1:
        wide = 16 // element_size
        vec = wide if aligned and c % wide == 0 else 1
        groups = c // vec
        m = groups // math.gcd(groups, THREADS)
        need = -(-outer * groups // (THREADS * VECTORS_PER_THREAD))
        return (outer, c, inner), vec, m * max(1, min(cap // m,
                                                      -(-need // m))), 1
    chunk = max(1, min(CHUNK_MAX, -(-THREADS * ROWS_PER_THREAD // inner)))
    grid = max(1, min(cap, -(-outer * c // chunk)))
    return (outer, c, inner), 1, grid, chunk


_PARAMS = ("conv bias", "running_mean", "running_var", "weight", "bias")


def _check_inputs(x, params, residual) -> None:
    """Raise ValueError for what the kernel does not take, before any
    launch (the layout is checked by the plan)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the conv epilogue takes bfloat16 or float32, got "
                         f"{x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"no conv epilogue kernel for device {x.device}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"no conv epilogue launch for shape {tuple(x.shape)}")
    c, index = x.shape[1], x.get_device()
    for name, t in zip(_PARAMS, params):
        if t is not None and (t.dtype is not torch.float32
                              or t.get_device() != index or t.shape != (c,)
                              or not t.is_contiguous()):
            raise ValueError(
                f"the conv epilogue takes a contiguous float32 {name} of "
                f"({c},) on {x.device}, got {tuple(t.shape)} {t.dtype} "
                f"{t.device}")
    if residual is not None and (residual.dtype is not x.dtype
                                 or residual.shape != x.shape
                                 or residual.get_device() != index):
        raise ValueError(
            f"the residual {tuple(residual.shape)} {residual.dtype} "
            f"{residual.device} is not the conv output's {tuple(x.shape)} "
            f"{x.dtype} {x.device}")


@functools.lru_cache(maxsize=4096)
def _plan(shape, strides, element_size, aligned, index):
    return plan(shape, strides, element_size, aligned, _sm_count(index))


def eval_epilogue(x: torch.Tensor, conv_bias: torch.Tensor | None,
                  mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor | None, bias: torch.Tensor | None,
                  eps: float, act: str | None = None, slope: float = 0.0,
                  act_first: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue of the conv output ``x`` (channels at dim 1) by the
    kernel: a new tensor in ``x``'s dtype and layout."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    params = (conv_bias, mean, var, weight, bias)
    _check_inputs(x, params, residual)
    strides = x.stride()
    if residual is not None and residual.stride() != strides:
        residual = torch.empty_like(x).copy_(residual)
    out = torch.empty_like(x)
    aligned = (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
               and (residual is None or residual.data_ptr() % 16 == 0))
    index = x.get_device()
    (outer, c, inner), vec, grid, chunk = _plan(
        tuple(x.shape), strides, x.element_size(), aligned, index)
    # the launch goes to the current device's stream: x's device made
    # current only where it is not.  The stream's handle is read raw, as
    # the code torch.compile writes reads it: a Stream object costs the
    # host microseconds a call, 87 calls a B3 forward
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _library().bn_eval_epilogue(
            _DTYPES[x.dtype], vec, ACTS[act], int(bool(act_first)),
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            *(None if t is None else t.data_ptr() for t in params),
            eps, slope, outer, c, inner, grid, chunk, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"conv epilogue launch failed: cudaError {err}")
    profiling.count("conv_epilogue", "rows" if inner == 1 else "mid")
    return out


def _activate(z: torch.Tensor, act: str | None, slope: float) -> torch.Tensor:
    if act == "silu":
        return z * torch.sigmoid(z)
    if act == "leaky_relu":
        return torch.where(z > 0, z, z * slope)
    return z


def eval_epilogue_plain(x: torch.Tensor, conv_bias: torch.Tensor | None,
                        mean: torch.Tensor, var: torch.Tensor,
                        weight: torch.Tensor | None,
                        bias: torch.Tensor | None, eps: float,
                        act: str | None = None, slope: float = 0.0,
                        act_first: bool = False,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`eval_epilogue`'s function as tensor ops on any device, in f32
    (f64 for an f64 ``x``), rounded once to ``x``'s dtype."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    shape = [1] * x.ndim
    shape[1] = -1

    def col(t):
        return None if t is None else t.to(wide).view(shape)

    b = col(conv_bias) if conv_bias is not None else 0.0
    s = torch.rsqrt(var.to(wide) + eps)
    if weight is not None:
        s = s * weight.to(wide)
    t = -mean.to(wide) * s
    if bias is not None:
        t = t + bias.to(wide)
    s, t = s.view(shape), t.view(shape)
    xw = x.to(wide)
    if act_first:
        z = _activate(xw + b, act, slope) * s + t
    else:
        z = _activate(xw * s + (t + b * s), act, slope)
    if residual is not None:
        z = z + residual.to(wide)
    return z.to(x.dtype)
