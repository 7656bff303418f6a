"""The featurizer's (K1's) work, by fixed formulas of the geometry: never
the program's FFT plan, ring or operator constants, so a redesign of the
kernel cannot move its own yardstick.

A mel kernel, a frame: the Hann window (``n_fft`` products), a real FFT
of ``n_fft`` points (``2.5 n_fft log2 n_fft`` operations, half the
``5 N log2 N`` of a complex one), the power on the bins the bank reads (3
a bin) and the mel products (2 a non-zero of the bank).  Its bytes: the
clips read once, the mel written once.  PCEN, an element: 12 operations at
the float32 rate and 4 transcendentals at the MUFU rate, 4 bytes read and
the output written (``chip_smoke.py:636-650``, ``pcen_bound``).  The
per-clip min-max of the normalize fold reads the clips once.

A kernel's bound is the larger of its operations at the peak its
precision names (bfloat16 tensor cores for the ``"default"`` tier's
``mel_bf16_kernel``, float32 for the exact ``mel_power_kernel`` and the
rest) and its bytes at the memory rate (``chip_smoke.py:623-633``,
``bound_ms``).
"""

from __future__ import annotations

import math

import numpy as np

from portbench.counts import peaks
from portbench.reference.featurizer import frame_count, mel_bank

PCEN_FLOPS, PCEN_TRANSCENDENTALS = 12, 4
# profiler kernel name -> the peak its operations run at
MEL_KERNELS = {"mel_bf16_kernel": peaks.PEAK_BF16_FLOPS,
               "mel_bf16x3_kernel": peaks.PEAK_BF16_FLOPS,
               "mel_power_kernel": peaks.PEAK_FP32_FLOPS}
KERNELS = (*MEL_KERNELS, "pcen_kernel", "clip_minmax_kernel")


def kernel_of(name: str) -> str | None:
    """The K1 kernel a profiler name (``void mel_bf16_kernel<...>(...)``)
    launches, or None."""
    for k in KERNELS:
        if k in name:
            return k
    return None


def bank_shape(geometry: dict) -> tuple[int, int]:
    """(bins the bank reads, non-zeros of the bank)."""
    g = geometry
    bank = mel_bank(g["sr"], g["n_mels"], g["fmin"], g["fmax"], g["n_fft"],
                    g["break_freq"])
    return (int(np.flatnonzero(bank.max(axis=0) > 0)[-1]) + 1,
            int(np.count_nonzero(bank)))


def mel_ops_per_frame(geometry: dict) -> float:
    n = geometry["n_fft"]
    bins, nnz = bank_shape(geometry)
    return n + 2.5 * n * math.log2(n) + 3 * bins + 2 * nnz


def frames(geometry: dict) -> int:
    return frame_count(clip_samples(geometry), geometry["hop_length"])


def clip_samples(geometry: dict) -> int:
    return int(geometry["sr"] * geometry["clip_seconds"])


def ops_per_clip(geometry: dict, k1: dict) -> float:
    """Every K1 operation a clip takes in this cell (mel, and PCEN where the
    cell's ``k1`` entry has it)."""
    ops = mel_ops_per_frame(geometry) * frames(geometry)
    if k1.get("pcen"):
        elems = geometry["n_mels"] * frames(geometry)
        ops += elems * (PCEN_FLOPS + PCEN_TRANSCENDENTALS)
    return ops


def bound_s(kernel: str, batch: int, geometry: dict, k1: dict) -> float:
    """The least time one launch of ``kernel`` on ``batch`` clips could
    take on the card.  ``k1`` is the cell's entry: ``mel_out_bytes``, the
    bytes of an element the mel kernel writes (4 for float32, 2 for
    bfloat16), and ``pcen_out_bytes``, PCEN's."""
    g = geometry
    elems = batch * g["n_mels"] * frames(g)
    clip_bytes = batch * clip_samples(g) * 4
    if kernel in MEL_KERNELS:
        t_ops = (batch * frames(g) * mel_ops_per_frame(g)
                 / MEL_KERNELS[kernel])
        t_bytes = (clip_bytes + elems * k1["mel_out_bytes"]) / peaks.PEAK_BYTES_S
    elif kernel == "pcen_kernel":
        t_ops = max(elems * PCEN_FLOPS / peaks.PEAK_FP32_FLOPS,
                    elems * PCEN_TRANSCENDENTALS / peaks.MUFU_S)
        t_bytes = elems * (4 + k1["pcen_out_bytes"]) / peaks.PEAK_BYTES_S
    elif kernel == "clip_minmax_kernel":
        t_ops = batch * clip_samples(g) * 2 / peaks.PEAK_FP32_FLOPS
        t_bytes = clip_bytes / peaks.PEAK_BYTES_S
    else:
        raise ValueError(f"not a K1 kernel: {kernel}")
    return max(t_ops, t_bytes)
