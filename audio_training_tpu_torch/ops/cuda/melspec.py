"""Fused power spectrum + mel projection: the CUDA kernel ``csrc/melspec.cu``
and its plain PyTorch version.

Port of ``audio_training_tpu/ops/pallas/melspec.py`` (``_power_mel_kernel``
and ``fused_power_mel``).  ``out[b, t, m] = sum_f (re^2 + im^2)[b, t, f] *
W[f, m]`` in exact fp32, output ``(B, T, M)`` time-major.  For CUDA tensors
the wrappers launch the kernel or raise; for CPU tensors they compute
:func:`power_mel_plain`.  The kernel walks each filter's band of bins
(:func:`band_walk_plan`, built once per weight tensor on the host) over the
power of the bank's support, instead of the dense product: bins outside
every band enter no sum.

Two entries: :func:`fused_power_mel` keeps the JAX signature (real and
imaginary parts as two float32 tensors); :func:`fused_power_mel_complex`
takes the complex64 STFT itself, which the kernel reads interleaved through
``torch.view_as_real``, so the caller pays for no re/im split copy.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.ops.mel import band_tables
from audio_training_tpu_torch.utils import profiling

# csrc/melspec.cu's tile: ROWS STFT rows per block, staged as ROWS x support
# f32, and RPT rows per thread in the band walk
ROWS, RPT = 16, 8
MAX_SUPPORT = 232448 // (4 * ROWS)  # bins of support one block can stage

# Launches of the kernel since the last reset, counted where it launches.
profiling.register_counters("melspec", ["power_mel"])


def launch_counts() -> dict[str, int]:
    return profiling.counts("melspec")


def reset_launch_counts() -> None:
    profiling.reset_counts("melspec")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("melspec")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pm_power_mel.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr,
                                 ptr, ptr, i32, ptr, ptr]
    lib.pm_power_mel.restype = i32
    return lib


def power_mel_plain(
    stft_re: torch.Tensor, stft_im: torch.Tensor, mel_weights_t: torch.Tensor
) -> torch.Tensor:
    """The plain version of the kernel: (B, T, F) x2, (F, M) -> (B, T, M)."""
    return torch.einsum(
        "btf,fm->btm", stft_re * stft_re + stft_im * stft_im, mel_weights_t
    )


class BandWalkPlan(NamedTuple):
    """What the kernel walks: each filter's band (start, length, offset into
    the flat weights, the flat weights; :func:`ops.mel.band_tables` of the
    ``(M, F)`` bank) and the support ``[lo, lo + support)``, the union of
    the bands."""
    start: np.ndarray
    length: np.ndarray
    offset: np.ndarray
    weights: np.ndarray
    lo: int
    support: int


def band_walk_plan(mel_weights_t) -> BandWalkPlan:
    """The band walk of an ``(F, M)`` weight matrix."""
    start, length, offset, flat = band_tables(np.asarray(mel_weights_t).T)
    used = length > 0
    lo = int(start[used].min()) if used.any() else 0
    hi = int((start + length)[used].max()) if used.any() else 0
    return BandWalkPlan(start, length, offset, flat, lo, hi - lo)


# id(weight tensor) -> (weak reference, its version, plan, device tables):
# the host builds a bank's plan once, not per call
_PLANS: dict[int, tuple] = {}


def _device_plan(mel_weights_t: torch.Tensor):
    key = id(mel_weights_t)
    hit = _PLANS.get(key)
    if (hit is not None and hit[0]() is mel_weights_t
            and hit[1] == mel_weights_t._version):
        return hit[2], hit[3]
    plan = band_walk_plan(mel_weights_t.detach().cpu().numpy())
    if plan.support > MAX_SUPPORT:
        raise ValueError(
            f"the mel bank's support spans {plan.support} bins; the kernel "
            f"stages at most {MAX_SUPPORT}")
    tables = tuple(torch.as_tensor(t, device=mel_weights_t.device)
                   for t in plan[:4])
    _PLANS[key] = (weakref.ref(mel_weights_t,
                               lambda _, k=key: _PLANS.pop(k, None)),
                   mel_weights_t._version, plan, tables)
    return plan, tables


def _check_weights(mel_weights_t: torch.Tensor, n_freq: int, device) -> None:
    if mel_weights_t.ndim != 2 or mel_weights_t.dtype != torch.float32:
        raise ValueError(
            f"mel_weights_t must be (F, M) float32, got "
            f"{tuple(mel_weights_t.shape)} {mel_weights_t.dtype}"
        )
    if mel_weights_t.shape[0] != n_freq:
        raise ValueError(
            f"mel_weights_t has {mel_weights_t.shape[0]} bins, the STFT "
            f"{n_freq}"
        )
    if mel_weights_t.device != device:
        raise ValueError(
            f"mel_weights_t is on {mel_weights_t.device}, the STFT on {device}"
        )


def fused_power_mel(
    stft_re: torch.Tensor, stft_im: torch.Tensor, mel_weights_t: torch.Tensor
) -> torch.Tensor:
    """``out[b, t, m] = sum_f (re^2 + im^2)[b, t, f] * W[f, m]``.

    stft_re / stft_im: (B, T, F) float32; mel_weights_t: (F, M) float32.
    Returns (B, T, M) float32."""
    if (stft_re.ndim != 3 or stft_re.dtype != torch.float32
            or stft_im.shape != stft_re.shape
            or stft_im.dtype != torch.float32
            or stft_im.device != stft_re.device):
        raise ValueError(
            "stft_re / stft_im must be two (B, T, F) float32 tensors on one "
            f"device, got {tuple(stft_re.shape)} {stft_re.dtype} "
            f"{stft_re.device} and {tuple(stft_im.shape)} {stft_im.dtype} "
            f"{stft_im.device}"
        )
    _check_weights(mel_weights_t, stft_re.shape[-1], stft_re.device)
    if stft_re.device.type == "cpu":
        return power_mel_plain(stft_re, stft_im, mel_weights_t)
    if not (stft_re.is_contiguous() and stft_im.is_contiguous()):
        raise ValueError("stft_re / stft_im must be contiguous")
    return _launch(stft_re.data_ptr(), stft_im.data_ptr(), 1,
                   stft_re.shape, mel_weights_t)


def fused_power_mel_complex(
    spec: torch.Tensor, mel_weights_t: torch.Tensor
) -> torch.Tensor:
    """:func:`fused_power_mel` of ``spec.real`` and ``spec.imag``, for a
    (B, T, F) complex64 STFT, read in place."""
    if spec.ndim != 3 or spec.dtype != torch.complex64:
        raise ValueError(
            f"spec must be (B, T, F) complex64, got {tuple(spec.shape)} "
            f"{spec.dtype}"
        )
    _check_weights(mel_weights_t, spec.shape[-1], spec.device)
    if spec.device.type == "cpu":
        return power_mel_plain(spec.real, spec.imag, mel_weights_t)
    if not spec.is_contiguous():
        raise ValueError("spec must be contiguous (time-major (B, T, F))")
    pairs = torch.view_as_real(spec)  # (B, T, F, 2) float32, interleaved
    re = pairs.data_ptr()
    return _launch(re, re + pairs.element_size(), 2, spec.shape,
                   mel_weights_t)


def _launch(re: int, im: int, stride: int, shape: torch.Size,
            mel_weights_t: torch.Tensor) -> torch.Tensor:
    device = mel_weights_t.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    batch, frames, n_freq = shape
    rows, n_mels = batch * frames, mel_weights_t.shape[1]
    if not 0 < rows < 2**31 or n_freq == 0:
        raise ValueError(f"no kernel launch for an STFT of shape "
                         f"{tuple(shape)}")
    plan, tables = _device_plan(mel_weights_t)
    out = torch.empty((batch, frames, n_mels), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = _library().pm_power_mel(
            re, im, stride, rows, n_freq, plan.lo, plan.support,
            *(t.data_ptr() for t in tables), n_mels, out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"power_mel launch failed: cudaError {err}")
    profiling.count("melspec", "power_mel")
    return out
