"""Fused waveform -> mel power [-> PCEN] featurizer: the CUDA kernel
``csrc/fused_featurizer.cu`` and its plain PyTorch version.

Port of ``audio_training_tpu/ops/pallas/fused_featurizer.py``
(``_featurizer_kernel`` and ``FusedFeaturizer``).  For a CUDA tensor
``FusedFeaturizer.__call__`` launches the kernels (one launch for mel power,
a second for the PCEN epilogue, and with ``normalize_waveform`` a per-clip
min-max reduction ahead of the mel launch) or raises; for a CPU tensor it
computes :func:`fused_featurizer_plain` — tf-stft framing, ``torch.fft.rfft``,
power, an ``einsum`` with the mel weights and the ``ops.pcen`` pointwise
math.  The batch-global PCEN min-max runs in torch on the output in both
cases, in the output's dtype, as in the JAX class (``:869-872``).

Every mode of the JAX class is ported: tf ``pad_end`` framing or the
centered (librosa) framing of the long-recording Predictor
(``center=True``), any hop and frame count, f32 or bf16 output, at each
precision tier: the exact f32 ``"highest"`` (a register-resident FFT
kernel, :func:`fft_plan_tables`); the
``"default"`` tier (bf16 DFT products, f32 sums: the training featurizer),
a tensor-core kernel whose plain version is :func:`mel_power_bf16`; and the
``"bf16_3x"`` / ``"bf16_3x_manual"`` tiers (each DFT product as three bf16
passes over hi/lo splits), a third tensor-core kernel whose plain version is
:func:`mel_power_bf16_3x`.  The two 3x names differ on the TPU only in where
the constant operator is split; here both launch the same kernel.  The two
folds of the JAX class run in every tier's kernel: ``normalize_waveform``
(the per-clip min-max of ``ops.features.normalize_rows``, from
:func:`clip_minmax`, applied in normalize_rows' own arithmetic) and
``frontend_params``
(badwinner2's MagTransform and per-mel-row BatchNorm on the mel output).  The ``ValueError``s left are the
JAX class's own contracts: the folds take tf framing only, and the frontend
fold excludes PCEN.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.ops.features import mel_power, normalize_rows
from audio_training_tpu_torch.ops.mel import band_tables
from audio_training_tpu_torch.ops.pcen import normalize_minmax_global, pcen
from audio_training_tpu_torch.ops.stft import (
    hann_window,
    num_frames_centered,
    num_frames_tf,
)
from audio_training_tpu_torch.utils import profiling

N_FFT = 4096
MAX_BINS = 1024  # bins 0..1023: the kernel computes no bin above these
R1, R2 = 32, 128  # "default" tier: n = 128 n1 + n2, k = k1 + 32 k2
PRECISIONS = ("highest", "default", "bf16_3x", "bf16_3x_manual")
FRONTEND_EPS = 1e-3  # the Keras BatchNorm epsilon of badwinner2's mel BN

# Launches of each kernel since the last reset, counted where they launch.
# A mel kernel is counted by tier and mode: tf framing (no suffix), centered
# framing ("_centered"), or tf framing with a fold ("_folded").
_MEL_COUNTERS = [f"fused_featurizer_mel{tier}{mode}"
                 for tier in ("", "_bf16", "_bf16x3")
                 for mode in ("", "_centered", "_folded")]
profiling.register_counters(
    "fused_featurizer", [*_MEL_COUNTERS, "fused_featurizer_pcen",
                         "clip_minmax"])


def launch_counts() -> dict[str, int]:
    return profiling.counts("fused_featurizer")


def reset_launch_counts() -> None:
    profiling.reset_counts("fused_featurizer")


def geometry_error(mel_weights: np.ndarray, n_fft: int) -> str | None:
    """Why the kernel cannot take this geometry, or None when it can."""
    if n_fft != N_FFT:
        return "fused featurizer requires n_fft=4096"
    support = np.flatnonzero(np.asarray(mel_weights).max(axis=0) > 0)
    if support.size and support[-1] >= MAX_BINS:
        return "filterbank support exceeds bin 1023"
    return None


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_featurizer")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ff_mel_power.argtypes = [
        ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr,
        i32, i32, ptr, ptr, f32, ptr, i32, ptr,
    ]
    lib.ff_mel_power.restype = i32
    tc_args = [
        ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr,
        i32, ptr, ptr, f32, ptr, i32, i32,
    ]
    lib.ff_mel_bf16.argtypes = [*tc_args, ptr]
    lib.ff_mel_bf16.restype = i32
    lib.ff_mel_bf16x3.argtypes = [*tc_args, ptr, ptr]  # and the scratch
    lib.ff_mel_bf16x3.restype = i32
    lib.ff_tc_config.argtypes = [i32, ptr, ptr, ptr, ptr]
    lib.ff_tc_config.restype = i32
    lib.ff_clip_minmax.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.ff_clip_minmax.restype = i32
    lib.ff_pcen.argtypes = [
        ptr, i32, i32, f32, f32, f32, f32, f32, ptr, i32, ptr,
    ]
    lib.ff_pcen.restype = i32
    return lib


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# The exact tier's FFT plan (csrc/fused_featurizer.cu, mel_power_kernel):
# the 2048-point FFT of the even/odd-packed frame as 2048 = 16 x 16 x 8, n =
# 128 a + 8 e + g, k = c + 16 h + 256 i, three register passes on 128
# threads a frame (pass 1: thread b = 8 e + g; pass 2: thread (c, g) = (lt
# & 15, lt >> 4); pass 3: thread (c, h mod 8), h and h + 8), two exchanges
# through shared memory and a natural-order store for the untangle.  The
# index maps below are the kernel's, in float2 elements of a frame's buffer.
# ---------------------------------------------------------------------------

FFT_THREADS = 128  # threads of one frame's FFT; slices of every mel walk
X1_STRIDE = 17  # exchange 1, padded so each half-warp hits 16 banks
# A block of any mel kernel stages (frames - 1) * hop + 4096 samples of its
# clip, at most SPAN_CAP: the exact kernel in two halves, even samples at
# ev[j], odd ones at od[j]; the tensor-core kernels in one run (span_pos)
SPAN_CAP = 8448
FRAMES_PER_BLOCK = 16


def frames_per_block(hop: int) -> int:
    """Frames a block of the mel kernels takes at this hop."""
    return min(FRAMES_PER_BLOCK, 1 + (SPAN_CAP - N_FFT) // hop)


def x1_index(b, c):
    """Exchange 1 (buffer X): pass 1's output ``Y[b][c]``."""
    return b * X1_STRIDE + c


def x2_index(c, g, h):
    """Exchange 2 (the same buffer): pass 2's output ``V[c][g][h]``."""
    return (g * 16 + h) * 16 + c


def x3_index(c, h, i):
    """Pass 3's output ``Z[c + 16 h + 256 i]`` in natural order (the same
    buffer), which the untangle reads at k and 2048 - k."""
    return c + 16 * h + 256 * i


def fft_plan_tables() -> tuple[np.ndarray, np.ndarray]:
    """The plan's inter-pass twiddles in float64 (the kernel gets them
    rounded once to f32, :class:`FusedFeaturizer`): ``tw1[c, b] =
    W2048^(b c)`` (16 x 128), applied after pass 1, and ``tw2[g, h] =
    W128^(g h)`` (8 x 16), after pass 2; W_N = exp(-2 pi i / N), exact
    zeros where cos or sin vanish."""
    c, b = np.arange(16)[:, None], np.arange(128)[None, :]
    g, h = np.arange(8)[:, None], np.arange(16)[None, :]
    tw1 = _unit((b * c) % 2048, 2048)
    tw2 = _unit((g * h) % 128, 128)
    return tw1[0] + 1j * tw1[1], tw2[0] + 1j * tw2[1]


def slot_walk(mel_of: np.ndarray, pos: np.ndarray, weights: np.ndarray,
              n_mels: int, threads: int = FFT_THREADS
              ) -> tuple[np.ndarray, ...]:
    """A balanced walk over a bank's non-zeros listed in filter order:
    entry i is weight ``weights[i]`` of filter ``mel_of[i]`` at position
    ``pos[i]`` of the kernel's power row.  The entries are cut into
    ``threads`` equal slices, each slice into pieces of one filter.  Thread
    t walks its slice as ``slot_w[:, t]`` (the weights, 0 past the slice)
    and ``slot_pos[:, t]`` (the positions, bit 16 set where a new piece
    starts), ``n_slots`` a multiple of 4 rows; its pieces are
    ``piece_off[t]:piece_off[t + 1]``, and filter m's mel is the sum of
    pieces ``mel_piece_off[m]:mel_piece_off[m + 1]`` in order (none for a
    filter without entries)."""
    mel_of = np.asarray(mel_of, np.int64)
    cuts = np.arange(threads + 1) * len(mel_of) // threads
    n_slots = max(4, -(-int(np.diff(cuts).max()) // 4) * 4)
    slot_w = np.zeros((n_slots, threads), np.float32)
    slot_pos = np.zeros((n_slots, threads), np.int32)
    piece_mel, piece_off = [], [0]
    for t in range(threads):
        lo, hi = cuts[t], cuts[t + 1]
        slot_w[:hi - lo, t] = weights[lo:hi]
        slot_pos[:hi - lo, t] = pos[lo:hi]
        new = np.flatnonzero(np.diff(mel_of[lo:hi])) + 1
        slot_pos[new, t] |= 1 << 16
        if hi > lo:
            piece_mel += [mel_of[lo], *mel_of[lo + new]]
        piece_off.append(len(piece_mel))
    mel_piece_off = np.searchsorted(np.asarray(piece_mel, np.int64),
                                    np.arange(n_mels + 1))
    return (slot_w, slot_pos, np.asarray(piece_off, np.int32),
            mel_piece_off.astype(np.int32))


def bank_entries(start: np.ndarray, length: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(filter, bin) of each non-zero of a bank's bands
    (:func:`ops.mel.band_tables`), in filter order."""
    mel_of = np.repeat(np.arange(len(start)), length)
    bins = np.concatenate([np.arange(s, s + n) for s, n in zip(start, length)]
                          + [np.zeros(0, np.int64)])
    return mel_of, bins


def mel_slots(start: np.ndarray, length: np.ndarray, flat: np.ndarray,
              threads: int = FFT_THREADS) -> tuple[np.ndarray, ...]:
    """The exact kernel's balanced mel walk: the :func:`slot_walk` of the
    bank's bands over the bins (``slot_pos`` is the bin)."""
    mel_of, bins = bank_entries(start, length)
    return slot_walk(mel_of, bins, flat, len(start), threads)


def _dif_flops(n: int) -> int:
    """Real operations of one in-register radix-2 DIF n-point DFT: 4 per
    butterfly, 6 per general twiddle, 4 per W16^2 / W16^6, 0 per 1 / -i."""
    flops, h = 0, n // 2
    while h >= 1:
        for j in range(h):
            m = j * (8 // h)
            twiddle = 0 if m in (0, 4) else 4 if m in (2, 6) else 6
            flops += (n // (2 * h)) * (4 + twiddle)
        h //= 2
    return flops


# One frame's 2048-point FFT in the plan: 128 16-point DFTs and 15 twiddles
# (6 flops each) per thread in passes 1 and 2, 256 8-point DFTs in pass 3
EXACT_FFT_FLOPS = (2 * 128 * (_dif_flops(16) + 15 * 6)
                   + 256 * _dif_flops(8))


def _complex_table(z: np.ndarray, device) -> torch.Tensor:
    """Complex values as an (n, 2) f32 tensor (the kernel's float2)."""
    pairs = np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return torch.as_tensor(pairs, device=device)


# ---------------------------------------------------------------------------
# The "default" tier: bf16 operands, f32 sums, rounded at six points only
# (csrc/fused_featurizer.cu, mel_bf16_kernel, states the contract)
# ---------------------------------------------------------------------------


def round_bf16(x) -> np.ndarray:
    """Round to the nearest bf16 value, ties to even, in ONE rounding from
    the given precision (float64 tables are not rounded to f32 first);
    returned as f32, in which every bf16 value is exact."""
    mant, exp = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.rint(mant * 256.0) / 256.0, exp).astype(np.float32)


def _unit(m: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """cos and -sin of 2 pi m / n in float64, exact zeros where they are 0."""
    ang = 2.0 * np.pi * np.asarray(m, np.float64) / n
    c, s = np.cos(ang), -np.sin(ang)
    c[np.abs(c) < 1e-12] = 0.0
    s[np.abs(s) < 1e-12] = 0.0
    return c, s


def _dft_tables_f64() -> dict[str, np.ndarray]:
    """The two DFT stages' operators in float64.

    ``d1_re``/``d1_im`` (n1, k1): W32^(n1 k1), built from a table of cos /
    -sin over j = n1 k1 mod 32 that is conjugate symmetric by construction
    (entry 32 - j mirrors entry j), so the planes of k1 and 32 - k1 are
    exact conjugates.  ``c2_re``/``c2_im`` (k1, n2, k2): the twiddle-folded
    stage-2 operator W4096^(n2 k1) W128^(n2 k2) = W4096^(n2 (k1 + 32 k2))."""
    c, s = _unit(np.arange(R1 // 2 + 1), R1)
    c = np.concatenate([c, c[1:R1 // 2][::-1]])
    s = np.concatenate([s, -s[1:R1 // 2][::-1]])
    idx = np.outer(np.arange(R1), np.arange(R1)) % R1
    n2, k1, k2 = np.arange(R2), np.arange(R1), np.arange(MAX_BINS // R1)
    m = (n2[None, :, None] * (k1[:, None, None] + R1 * k2[None, None, :])
         ) % N_FFT
    c2_re, c2_im = _unit(m, N_FFT)
    return {"d1_re": c[idx], "d1_im": s[idx], "c2_re": c2_re, "c2_im": c2_im}


@functools.cache
def dft_tables_split() -> dict[str, dict[str, np.ndarray]]:
    """The operators of :func:`_dft_tables_f64` split into two bf16 parts,
    as f32: ``["hi"][name] = bf16(v)`` and ``["lo"][name] = bf16(v - hi)``.
    The ``"default"`` tier uses ``hi``, the ``"bf16_3x"`` tier both (the
    stage-1 table stays conjugate symmetric, so the split planes of k1 and
    32 - k1 are exact conjugates too)."""
    hi, lo = {}, {}
    for name, v in _dft_tables_f64().items():
        hi[name] = round_bf16(v)
        lo[name] = round_bf16(v - hi[name].astype(np.float64))
    return {"hi": hi, "lo": lo}


def dft_tables_bf16() -> dict[str, np.ndarray]:
    """The ``"default"`` tier's operators (:func:`_dft_tables_f64`), each
    rounded once to bf16, as f32."""
    return dft_tables_split()["hi"]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest even) and hold it as f32."""
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 values held as f32: hi = bf16(x), lo =
    bf16(x - hi) (x - hi is exact in f32)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _framed(raw: torch.Tensor, hop: int, center: bool) -> torch.Tensor:
    """(B, samples) -> (B, frames, 4096), the frames the tensor-core kernels
    read: tf ``pad_end`` (zeros past the clip), or centered (2048 zeros on
    both sides, ``1 + n // hop`` frames; the kernels' ``left_pad``)."""
    n = raw.shape[-1]
    if center:
        frames = num_frames_centered(n, hop)
        raw = F.pad(raw, (N_FFT // 2, N_FFT // 2))
    else:
        frames = num_frames_tf(n, hop)
    pad = (frames - 1) * hop + N_FFT - raw.shape[-1]
    return F.pad(raw, (0, max(pad, 0))).unfold(-1, N_FFT, hop)[:, :frames]


def mel_power_bf16_3x(raw: torch.Tensor, mel_weights: torch.Tensor,
                      hop: int, center: bool = False) -> torch.Tensor:
    """The plain version of the ``"bf16_3x"`` tier kernel: (B, samples)
    f32 -> (B, n_mels, frames) f32 mel power, tf ``pad_end`` framing or
    with ``center`` the centered one (:func:`_framed`).  Each
    DFT product x . w is hi(w) hi(x) + lo(w) hi(x) + hi(w) lo(x) at the
    kernel's split points (the windowed samples x * hann, the f32 stage-1
    planes; the operators of :func:`dft_tables_split`), every sum f32
    (``einsum`` of bf16 values held as f32: each product is exact), power
    ``re^2 + im^2`` in f32 and the mel product with f32 weights."""
    dev = raw.device
    tab = {part: {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
           for part, t in dft_tables_split().items()}
    framed = _framed(raw, hop, center)
    batch, frames = framed.shape[:2]
    window = torch.as_tensor(hann_window(N_FFT), device=dev)
    xh, xl = _split((framed * window).reshape(batch, frames, R1, R2))

    def x3(eq, data_hi, data_lo, name):
        w_hi, w_lo = tab["hi"][name], tab["lo"][name]
        return (torch.einsum(eq, data_hi, w_hi)
                + torch.einsum(eq, data_hi, w_lo)
                + torch.einsum(eq, data_lo, w_hi))

    s1 = "btnm,nk->btkm"  # (n1, n2) -> (k1, n2)
    a_re = x3(s1, xh, xl, "d1_re")
    a_im = x3(s1, xh, xl, "d1_im")
    del xh, xl
    re_h, re_l = _split(a_re)
    im_h, im_l = _split(a_im)
    del a_re, a_im
    s2 = "btkm,kmq->btkq"  # (k1, n2) -> (k1, k2)
    x_re = x3(s2, re_h, re_l, "c2_re") - x3(s2, im_h, im_l, "c2_im")
    x_im = x3(s2, re_h, re_l, "c2_im") + x3(s2, im_h, im_l, "c2_re")
    power = x_re * x_re + x_im * x_im  # (B, T, k1, k2)
    power = power.transpose(-1, -2).reshape(batch, frames, MAX_BINS)
    return torch.einsum("mf,btf->bmt", mel_weights[:, :MAX_BINS].float(),
                        power)


def mel_power_bf16(raw: torch.Tensor, mel_weights: torch.Tensor,
                   hop: int, center: bool = False) -> torch.Tensor:
    """The plain version of the ``"default"`` tier kernel: (B, samples) f32
    -> (B, n_mels, frames) f32 mel power, tf ``pad_end`` framing or with
    ``center`` the centered one (:func:`_framed`), with the
    kernel's decomposition and its six bf16 rounding points (windowed
    samples, stage-1 operator, stage-1 planes, stage-2 operator, power, mel
    weights) and f32 sums (``einsum`` of bf16 values held as f32: each
    product is exact).  Bins past 1023 carry no mel weight
    (:func:`geometry_error`)."""
    dev = raw.device
    tab = {k: torch.as_tensor(v, device=dev)
           for k, v in dft_tables_bf16().items()}
    framed = _framed(raw, hop, center)
    batch, frames = framed.shape[:2]
    window = torch.as_tensor(hann_window(N_FFT), device=dev)
    x = _bf16(framed * window).reshape(batch, frames, R1, R2)  # (n1, n2)
    a_re = _bf16(torch.einsum("btnm,nk->btkm", x, tab["d1_re"]))
    a_im = _bf16(torch.einsum("btnm,nk->btkm", x, tab["d1_im"]))
    x_re = (torch.einsum("btkm,kmq->btkq", a_re, tab["c2_re"])
            - torch.einsum("btkm,kmq->btkq", a_im, tab["c2_im"]))
    x_im = (torch.einsum("btkm,kmq->btkq", a_re, tab["c2_im"])
            + torch.einsum("btkm,kmq->btkq", a_im, tab["c2_re"]))
    power = _bf16(x_re * x_re + x_im * x_im)  # (B, T, k1, k2)
    power = power.transpose(-1, -2).reshape(batch, frames, MAX_BINS)
    w = _bf16(mel_weights[:, :MAX_BINS].float())
    return torch.einsum("mf,btf->bmt", w, power)


_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3  # mma fragment group and thread in group


def _pack_bf16(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Two bf16 values (held exactly as f32) in one uint32, ``lo`` in the
    lower half, as mma fragments hold them."""
    bits = lambda v: np.asarray(v, np.float32).view(np.uint32) >> 16
    return bits(lo) | (bits(hi) << 16)


def a_fragments(a: np.ndarray) -> np.ndarray:
    """(M, K) bf16 matrix -> (M/16, K/16, 32 lanes, 4) uint32 A fragments of
    ``mma.sync.m16n8k16.row``: registers hold A(g, 2t..), A(g+8, 2t..),
    A(g, 2t+8..), A(g+8, 2t+8..) of each 16 x 16 tile."""
    mt = np.arange(a.shape[0] // 16)[:, None, None]
    ks = np.arange(a.shape[1] // 16)[None, :, None]
    r, c = 16 * mt + _G, 16 * ks + 2 * _T
    regs = [(r, c), (r + 8, c), (r, c + 8), (r + 8, c + 8)]
    return np.stack([_pack_bf16(a[i, j], a[i, j + 1]) for i, j in regs], -1)


def b_fragments(b: np.ndarray) -> np.ndarray:
    """(K, N) bf16 matrix -> (K/16, N/8, 32 lanes, 2) uint32 B fragments of
    ``mma.sync.m16n8k16.col``: B(2t..2t+1, g) and B(2t+8..2t+9, g)."""
    ks = np.arange(b.shape[0] // 16)[:, None, None]
    j = np.arange(b.shape[1] // 8)[None, :, None]
    k, n = 16 * ks + 2 * _T, 8 * j + _G
    return np.stack([_pack_bf16(b[k, n], b[k + 1, n]),
                     _pack_bf16(b[k + 8, n], b[k + 9, n])], -1)


def stage1_operator(tables: dict[str, np.ndarray]) -> np.ndarray:
    """The kernel's stage-1 A matrix (32 planes x 32 n1) from ``tables``
    (one part of :func:`dft_tables_split`): rows 0..16 the cos rows of k1'
    = 0..16, rows 17..31 the -sin rows of k1' = 1..15 (the planes of a real
    frame's conjugate fold)."""
    re, im = tables["d1_re"], tables["d1_im"]
    return np.concatenate([re[:, :R1 // 2 + 1].T, im[:, 1:R1 // 2].T])


def stage2_operator(tables: dict[str, np.ndarray], k1: int) -> np.ndarray:
    """The kernel's stage-2 B matrix of ``k1`` (256 x 64) from ``tables``
    as in :func:`stage1_operator`.  Rows: re then im of the stored plane
    k1' = min(k1, 32 - k1) over n2; for k1 > 16 the plane is the conjugate,
    whose sign is folded in here.  Column 8 j + c with j = 2 q + r is re
    (r = 0) or im (r = 1) of X[k1 + 32 (8 q + c)]."""
    re, im = tables["c2_re"][k1], tables["c2_im"][k1]  # (n2, k2)
    s = 1.0 if k1 <= R1 // 2 else -1.0
    b = np.concatenate([np.stack([re, im], -1), np.stack([-s * im, s * re], -1)])
    return b.reshape(2 * R2, 4, 8, 2).transpose(0, 1, 3, 2).reshape(2 * R2, 64)


@functools.cache
def dft_fragments() -> tuple[np.ndarray, np.ndarray]:
    """(stage-1 A fragments (2, 2, 32, 4), stage-2 B fragments of every k1
    (32, 16, 8, 32, 2)), uint32, in the order the kernel loads them."""
    t = dft_tables_bf16()
    return (a_fragments(stage1_operator(t)),
            np.stack([b_fragments(stage2_operator(t, k)) for k in range(R1)]))


# The "bf16_3x" kernel runs the conjugate-folded planes in two halves of 16
# stage-1 rows each (csrc/fused_featurizer.cu, mel_bf16x3_kernel): half 0
# re of k1' = 0..7 and 16, im of 1..7; half 1 re and im of k1' = 8..15.
# Rows of stage1_operator(tables) in that order:
X3_ROWS = np.array([*range(8), 16, *range(17, 24),
                    *range(8, 16), *range(24, 32)])


@functools.cache
def dft_fragments_x3() -> tuple[np.ndarray, np.ndarray]:
    """The ``"bf16_3x"`` kernel's operator fragments, uint32, in load
    order: stage 1 (2 halves, 2 k-steps, [hi, lo], 32 lanes, 4), A
    fragments of the row-permuted operator; stage 2 (32 k1, 16 k-steps, 8
    n-tiles, 32 lanes, 4): per lane the hi B fragment's two registers, then
    the lo one's."""
    parts = [dft_tables_split()[p] for p in ("hi", "lo")]
    d1 = np.stack([a_fragments(stage1_operator(t)[X3_ROWS]) for t in parts],
                  axis=2)
    op2 = np.stack([
        np.concatenate([b_fragments(stage2_operator(t, k)) for t in parts],
                       axis=-1)
        for k in range(R1)])
    return d1, op2


# ---------------------------------------------------------------------------
# The tensor-core kernels' layouts (csrc/fused_featurizer.cu): the
# operator ring's chunk order, the power tiles and the balanced walks over
# them.  A block takes one clip and frames_per_block(hop) frames at a time;
# blocks run in clusters of TC_CLUSTER clips, each block copying its
# 1/TC_CLUSTER of every RING_CHUNK-byte chunk of the stage-2 operator's re
# rows to all of them.
# ---------------------------------------------------------------------------

TC_CLUSTER = 2
TC_FRAMES = 16  # frames a block takes at once (one m16 tile)
RING_CHUNK = 16384  # bytes
# The "bf16_3x" kernel's halves: entry e of half h is k1 = X3_K1[h, e]; warp
# w takes entry w + 8 r in round r
X3_K1 = np.array([[*range(8), 16, *range(25, 32)],
                  [*range(8, 16), *range(17, 25)]])


def span_pos(j):
    """Word of sample j of a tensor-core block's staged span: 8 words of
    padding every 256 samples, so that a warp's fragment loads (8
    consecutive samples at 4 strides of 256) hit 32 banks."""
    return j + 8 * (j >> 8)


def tc_power_pos(k):
    """Bin k's place in a frame's row of the ``"default"`` kernel's bf16
    power tile: 2 of padding every 64 bins (rows of 1064), so that each
    scatter store (frames g, g + 8, bins 64 t + const) hits 32 banks."""
    return k + 2 * (k >> 6)


def x3_power_pos(k2, e):
    """(k2, entry e)'s place in a frame's row of the ``"bf16_3x"`` kernel's
    f32 half-power tile: rows of 17 by k2 // 2, odd k2 after even ones
    (rows of 548), so that each scatter store hits 32 banks."""
    return (k2 & 1) * 272 + (k2 >> 1) * 17 + e


def ring_chunks(op2: np.ndarray) -> np.ndarray:
    """The ``"default"`` kernel's stage-2 B fragments (32 k1, 16 k-steps, 8
    n-tiles, 32 lanes, 2) in its ring's order.  Only the re rows travel
    (k-steps 0..7): the im rows' fragments are the re rows' with each
    n-tile pair swapped and signed (:func:`stage2_operator`: -s im, s
    re).  Chunk 8 r + ks holds k-step ks of k1 = w + 8 r for warps w =
    0..7, (8 warps, 8 n-tiles, 32 lanes, 2) uint32, 16 KB."""
    return np.ascontiguousarray(
        op2[:, :8].reshape(4, 8, 8, 8, 32, 2).transpose(0, 2, 1, 3, 4, 5))


def ring_chunks_x3(op2: np.ndarray) -> np.ndarray:
    """The ``"bf16_3x"`` kernel's stage-2 B fragments (32 k1, 16 k-steps, 8
    n-tiles, 32 lanes, 4) in its ring's order, the re rows only as in
    :func:`ring_chunks`: chunk ((2 h + r) 8 + ks) 2 + jh holds k-step ks,
    n-tiles 4 jh..4 jh + 3 of k1 = X3_K1[h, w + 8 r] for warps w = 0..7, (8
    warps, 4 n-tiles, 32 lanes, 4) uint32, 16 KB."""
    t = op2[X3_K1.reshape(2, 2, 8), :8]  # (h, r, w, ks, j, lane, 4)
    t = t.reshape(2, 2, 8, 8, 2, 4, 32, 4)  # j -> (jh, j)
    return np.ascontiguousarray(t.transpose(0, 1, 3, 4, 2, 5, 6, 7))


def tc_walk(start: np.ndarray, length: np.ndarray, flat: np.ndarray
            ) -> tuple[np.ndarray, ...]:
    """The ``"default"`` kernel's walk: the bank's bands over its power
    tile (:func:`tc_power_pos`), with the weights rounded to bf16."""
    mel_of, bins = bank_entries(start, length)
    return slot_walk(mel_of, tc_power_pos(bins), round_bf16(flat),
                     len(start))


def x3_walk(start: np.ndarray, length: np.ndarray, flat: np.ndarray
            ) -> tuple[np.ndarray, ...]:
    """The ``"bf16_3x"`` kernel's walks, one per half, stacked (2, ...):
    half h walks the bank's non-zeros whose bin k1 + 32 k2 has k1 in
    X3_K1[h], over its half-power tile (:func:`x3_power_pos`), with f32
    weights; both halves have the same number of slots."""
    mel_of, bins = bank_entries(start, length)
    entry = np.full((2, R1), -1)
    for h in range(2):
        entry[h, X3_K1[h]] = np.arange(16)
    walks = []
    for h in range(2):
        keep = entry[h, bins % R1] >= 0
        walks.append(slot_walk(
            mel_of[keep],
            x3_power_pos(bins[keep] // R1, entry[h, bins[keep] % R1]),
            flat[keep], len(start)))
    n_slots = max(w[0].shape[0] for w in walks)
    return tuple(np.stack([
        np.pad(w[i], ((0, n_slots - w[i].shape[0]), (0, 0))) if i < 2 else w[i]
        for w in walks]) for i in range(4))


class _Tier(NamedTuple):
    """A tensor-core tier's kernel: its C entry point, its launch counter,
    its operator fragments, their ring order, its walk, and whether it
    keeps partial mels in a scratch (16 x n_mels f32 a block)."""
    entry: str
    counter: str
    fragments: Callable[[], tuple[np.ndarray, np.ndarray]]
    ring: Callable[[np.ndarray], np.ndarray]
    walk: Callable[..., tuple[np.ndarray, ...]]
    scratch: bool


# the tiers other than the exact "highest"; both 3x names launch one kernel
_TENSOR_CORE = {
    "default": _Tier("ff_mel_bf16", "fused_featurizer_mel_bf16",
                     dft_fragments, ring_chunks, tc_walk, False),
    "bf16_3x": _Tier("ff_mel_bf16x3", "fused_featurizer_mel_bf16x3",
                     dft_fragments_x3, ring_chunks_x3, x3_walk, True),
}
_TENSOR_CORE["bf16_3x_manual"] = _TENSOR_CORE["bf16_3x"]


def tc_launch_config(precision: str) -> dict[str, int]:
    """A tensor-core tier's launch shape on the current card (builds the
    library): blocks a cluster, threads a block, dynamic shared memory a
    block in bytes, and how many such clusters the card holds at once."""
    vals = [ctypes.c_int() for _ in range(4)]
    _check(_library().ff_tc_config(int(precision != "default"),
                                   *map(ctypes.byref, vals)),
           f"{precision} cluster query")
    return dict(zip(("cluster", "threads", "smem_bytes", "active_clusters"),
                    (v.value for v in vals)))


def mel_counter(precision: str, center: bool = False,
                folded: bool = False) -> str:
    """The launch counter of the mel kernel that ``precision`` launches, in
    the centered framing or with a fold."""
    tier = (_TENSOR_CORE[precision].counter if precision in _TENSOR_CORE
            else "fused_featurizer_mel")
    return tier + ("_centered" if center else "_folded" if folded else "")


# ---------------------------------------------------------------------------
# The folds
# ---------------------------------------------------------------------------


def clip_minmax_plain(raw: torch.Tensor) -> torch.Tensor:
    """The plain version of the normalize fold's reduction: (B, samples)
    f32 -> (B, 2) f32 ``(min, max - min)`` of each clip, the two values
    ``normalize_rows`` subtracts and divides by."""
    mn, mx = raw.amin(dim=-1), raw.amax(dim=-1)
    return torch.stack([mn, mx - mn], dim=-1)


def clip_minmax(raw: torch.Tensor) -> torch.Tensor:
    """Per-clip ``(min, max - min)``, what the normalize fold reads: on CUDA
    the kernel ``clip_minmax_kernel`` (one block per clip), on the CPU
    :func:`clip_minmax_plain`."""
    if raw.ndim != 2 or raw.dtype != torch.float32:
        raise ValueError(
            f"raw must be (B, samples) float32, got {tuple(raw.shape)} "
            f"{raw.dtype}")
    if raw.device.type == "cpu":
        return clip_minmax_plain(raw)
    if raw.device.type != "cuda" or not raw.is_contiguous():
        raise ValueError(f"no kernel for a {raw.device} / non-contiguous raw")
    batch, samples = raw.shape
    if batch < 1 or samples < 1:
        raise ValueError(f"raw {tuple(raw.shape)} is empty")
    out = torch.empty((batch, 2), dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        _check(_library().ff_clip_minmax(
            raw.data_ptr(), batch, samples, out.data_ptr(), _stream(),
        ), "clip min-max")
    profiling.count("fused_featurizer", "clip_minmax")
    return out


def frontend_tables(frontend_params: tuple, n_mels: int,
                    device) -> tuple[float, torch.Tensor]:
    """``(a_power, bn_mean, bn_var)`` -> the frontend fold's power ``g =
    sigmoid(clip(a_power, -2, 1))`` and its (n_mels, 2) f32 per-row affine
    ``(s, b)``, ``s = 1 / sqrt(var + 1e-3)``, ``b = -mean * s``, each in f32
    as the JAX class computes them (``:525-528``, ``:855-862``)."""
    a_power, bn_mean, bn_var = (
        torch.as_tensor(v).detach().to("cpu", torch.float32).reshape(-1)
        for v in frontend_params)
    if a_power.numel() != 1 or bn_mean.numel() != n_mels \
            or bn_var.numel() != n_mels:
        raise ValueError(
            f"frontend_params must be (a_power (1,), bn_mean ({n_mels},), "
            f"bn_var ({n_mels},)), got {tuple(a_power.shape)}, "
            f"{tuple(bn_mean.shape)}, {tuple(bn_var.shape)}")
    a = a_power.clamp(-2.0, 1.0)
    g = (1.0 / (1.0 + torch.exp(-a))).item()
    s = 1.0 / torch.sqrt(bn_var + FRONTEND_EPS)
    return g, torch.stack([s, -bn_mean * s], dim=-1).to(device)


def frontend_plain(mel: torch.Tensor, g: float,
                   stats: torch.Tensor) -> torch.Tensor:
    """The plain version of the frontend fold on a (B, M, T) f32 mel:
    ``exp(g log(max(mel, 1e-30))) s[m] + b[m]``."""
    p = torch.exp(g * torch.log(mel.clamp_min(1e-30)))
    return p * stats[:, 0, None] + stats[:, 1, None]


def fused_featurizer_plain(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    hop: int,
    pcen_params: tuple[float, float, float, float, float] | None = None,
    out_dtype: torch.dtype = torch.float32,
    center: bool = False,
    precision: str = "highest",
    normalize_waveform: bool = False,
    frontend: tuple[float, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The plain version of the kernels: (B, samples) f32 -> (B, n_mels,
    frames) mel power, or the un-normalized PCEN image when ``pcen_params
    = (gain, bias, root, smooth, eps)``, converted to ``out_dtype``;
    ``center`` selects the centered framing, ``precision="default"`` the
    bf16 tier (:func:`mel_power_bf16`), ``"bf16_3x"`` or
    ``"bf16_3x_manual"`` the three-pass tier (:func:`mel_power_bf16_3x`).
    ``normalize_waveform`` runs ``normalize_rows`` on the clips first;
    ``frontend = (g, stats)`` of :func:`frontend_tables` applies
    :func:`frontend_plain` to the mel."""
    if normalize_waveform:
        raw = normalize_rows(raw)
    if precision == "default":
        out = mel_power_bf16(raw, mel_weights, hop, center)
    elif precision in ("bf16_3x", "bf16_3x_manual"):
        out = mel_power_bf16_3x(raw, mel_weights, hop, center)
    else:
        out = mel_power(raw, mel_weights, N_FFT, hop, center=center)
    if frontend is not None:
        out = frontend_plain(out, *frontend)
    if pcen_params is not None:
        out = pcen(out, *pcen_params, time_axis=2, normalize=False)
    return out.to(out_dtype)


class FusedFeaturizer:
    """Waveform -> PCEN'd (or raw) mel, one kernel per batch (two with
    PCEN, one more with the normalize fold).  Parity contracts as in the
    JAX class: mel power matches the tf-stft rfft path, PCEN matches
    ``ops.pcen.pcen`` including the frame-0 EMA seed and the batch-global
    min-max.  ``center=True`` frames as ``ops.stft.stft_centered`` does (pad
    2048 zeros both sides, ``1 + n//hop`` frames), in the kernel without a
    padded copy, at every tier."""

    @profiling.setup_span("setup.FusedFeaturizer")
    def __init__(
        self,
        mel_weights: np.ndarray,
        n_fft: int = 4096,
        hop: int = 281,
        precision: str = "highest",
        gain: float = 0.98,
        bias: float = 2.0,
        root: float = 2.0,
        smooth: float = 0.04,
        eps: float = 1e-6,
        center: bool = False,
        device: str | torch.device = "cuda",
    ):
        reason = geometry_error(mel_weights, n_fft)
        if reason:
            raise ValueError(reason)
        if precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision tier {precision!r}; the tiers are "
                f"{PRECISIONS}")
        self.hop = hop
        self.center = center
        self.precision = precision
        self.n_mels = mel_weights.shape[0]
        self.pcen_params = (gain, bias, root, smooth, eps)
        self.mel_weights = torch.as_tensor(
            np.asarray(mel_weights, np.float32), device=device
        )
        self.device = self.mel_weights.device  # "cuda" resolved to "cuda:N"
        start, length, _, flat = band_tables(mel_weights)
        self.n_bins = int((start + length).max())
        to_dev = functools.partial(torch.as_tensor, device=self.device)
        tier = _TENSOR_CORE.get(precision)
        # the tier's balanced mel walk: the exact tier's over the bins, a
        # tensor-core tier's over its power tile
        walk = (mel_slots(start, length, flat) if tier is None
                else tier.walk(start, length, flat))
        self.slot_w, self.slot_pos, self.piece_off, self.mel_piece_off = (
            to_dev(t) for t in walk)
        self.n_slots = walk[0].shape[-2]
        self.window = to_dev(hann_window(N_FFT))
        # the exact tier's inter-pass twiddles: W2048^(b c) at c * 128 + b,
        # then W128^(g h) at 2048 + g * 16 + h; the untangle's
        # exp(-2 pi i k / 4096) in post_tw
        tw1, tw2 = fft_plan_tables()
        self.fft_tw = _complex_table(
            np.concatenate([tw1.ravel(), tw2.ravel()]), self.device)
        self.post_tw = _complex_table(
            np.exp(-2j * np.pi * np.arange(MAX_BINS) / N_FFT), self.device
        )
        if tier is not None:
            # the tier's operators in fragment order, stage 2's re rows in
            # its ring's chunk order (512 KB for "default", 1 MB of hi/lo
            # for "bf16_3x")
            d1, op2 = tier.fragments()
            self.d1_frag = to_dev(d1.view(np.int32))
            self.op2_ring = to_dev(tier.ring(op2).view(np.int32))
        self.tc_config = None  # a tensor-core tier's, at its first launch

    def table_bytes(self) -> int:
        """Bytes of the tables this tier's mel kernel reads: the window, the
        operators (tensor-core tiers) or the FFT twiddles (the exact
        tier), and the mel walk."""
        tables = ((self.d1_frag, self.op2_ring) if hasattr(self, "op2_ring")
                  else (self.fft_tw, self.post_tw))
        return sum(t.numel() * t.element_size() for t in (
            self.window, *tables, self.slot_w, self.slot_pos, self.piece_off,
            self.mel_piece_off))

    def __call__(
        self,
        raw: torch.Tensor,
        pcen: bool = True,
        normalize: bool = True,
        normalize_waveform: bool = False,
        frontend_params: tuple | None = None,
        out_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """(B, samples) f32 -> (B, n_mels, frames) mel power or PCEN image.

        ``normalize_waveform`` folds the per-clip min-max normalize
        (``ops.features.normalize_rows``) into the kernel's sample loads.
        ``frontend_params = (a_power, bn_mean, bn_var)`` applies badwinner2's
        MagTransform and per-mel-row BatchNorm to the mel output, so the
        whole pre-CNN chain runs in the featurizer (not with ``pcen``).

        ``out_dtype=torch.bfloat16`` is the f32 result converted at the
        store: bitwise the cast of the f32 output (for ``normalize=False``
        paths; the PCEN min-max then runs in bf16 on the bf16 output)."""
        if frontend_params is not None and pcen:
            raise ValueError(
                "frontend_params is the badwinner2 frontend; PCEN fronts "
                "the pretrained-backbone models only"
            )
        if self.center and (normalize_waveform or frontend_params is not None):
            raise ValueError(
                "normalize_waveform/frontend_params implement the training "
                "pipeline's tf-stft convention, not the centered one"
            )
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
        if raw.ndim != 2 or raw.dtype != torch.float32:
            raise ValueError(
                f"raw must be (B, samples) float32, got {tuple(raw.shape)} "
                f"{raw.dtype}"
            )
        if raw.device != self.device:
            raise ValueError(
                f"raw is on {raw.device}, the featurizer on {self.device}"
            )
        params = self.pcen_params if pcen else None
        frontend = (None if frontend_params is None else frontend_tables(
            frontend_params, self.n_mels, self.device))
        if raw.device.type == "cpu":
            out = fused_featurizer_plain(
                raw, self.mel_weights, self.hop, params, out_dtype,
                self.center, self.precision, normalize_waveform, frontend,
            )
        else:
            out = self._launch(raw, params, out_dtype, normalize_waveform,
                               frontend)
        if pcen and normalize:
            out = normalize_minmax_global(out)
        return out

    def _launch(self, raw, pcen_params, out_dtype, normalize_waveform,
                frontend) -> torch.Tensor:
        if raw.device.type != "cuda":
            raise ValueError(f"no kernel for device {raw.device}")
        if not raw.is_contiguous():
            raise ValueError("raw must be contiguous")
        tier = _TENSOR_CORE.get(self.precision)
        batch, samples = raw.shape
        if not 0 < batch <= 65535:
            raise ValueError(f"batch {batch} outside the kernel's grid")
        if self.center:
            left_pad, frames = N_FFT // 2, num_frames_centered(samples, self.hop)
        else:
            left_pad, frames = 0, num_frames_tf(samples, self.hop)
        mel_dtype = out_dtype if pcen_params is None else torch.float32
        mel = torch.empty(
            (batch, self.n_mels, frames), dtype=mel_dtype, device=raw.device
        )
        norm = clip_minmax(raw) if normalize_waveform else None
        fe_g, fe = (0.0, None) if frontend is None else frontend
        fold_args = (None if norm is None else norm.data_ptr(),
                     None if fe is None else fe.data_ptr(), fe_g)
        walk = (self.slot_w.data_ptr(), self.slot_pos.data_ptr(),
                self.n_slots, self.piece_off.data_ptr(),
                self.mel_piece_off.data_ptr(), self.n_mels)
        with torch.cuda.device(raw.device):
            if tier is not None:
                if self.tc_config is None:
                    self.tc_config = tc_launch_config(self.precision)
                clusters = self.tc_config["active_clusters"]
                scratch = []
                if tier.scratch:  # held until the launch is queued
                    part = torch.empty(
                        clusters * self.tc_config["cluster"] * TC_FRAMES
                        * self.n_mels, device=raw.device)
                    scratch = [part.data_ptr()]
                err = getattr(_library(), tier.entry)(
                    raw.data_ptr(), batch, samples, self.hop, left_pad,
                    frames, self.window.data_ptr(), self.d1_frag.data_ptr(),
                    self.op2_ring.data_ptr(), *walk, *fold_args,
                    mel.data_ptr(), int(mel_dtype == torch.bfloat16),
                    clusters, *scratch, _stream())
            else:
                err = _library().ff_mel_power(
                    raw.data_ptr(), batch, samples, self.hop, left_pad,
                    frames, self.window.data_ptr(), self.fft_tw.data_ptr(),
                    self.post_tw.data_ptr(), *walk, self.n_bins,
                    *fold_args, mel.data_ptr(),
                    int(mel_dtype == torch.bfloat16), _stream())
        _check(err, f"{self.precision} mel")
        profiling.count("fused_featurizer", mel_counter(
            self.precision, self.center,
            normalize_waveform or frontend is not None))
        if pcen_params is None:
            return mel
        return pcen_rows(mel, pcen_params, out_dtype)


def pcen_rows(
    mel: torch.Tensor,
    pcen_params: tuple[float, float, float, float, float],
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The PCEN epilogue on a (B, M, T) f32 mel power: the un-normalized
    PCEN image in ``out_dtype``.  On CUDA the kernel runs the EMA of each
    (clip, mel) row as a chunked scan over one warp's lanes; on the CPU the
    plain version,
    ``ops.pcen.pcen(mel, *params, time_axis=2, normalize=False)``."""
    if mel.ndim != 3 or mel.dtype != torch.float32:
        raise ValueError(
            f"mel must be (B, M, T) float32, got {tuple(mel.shape)} {mel.dtype}"
        )
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if mel.device.type == "cpu":
        return pcen(mel, *pcen_params, time_axis=2,
                    normalize=False).to(out_dtype)
    if mel.device.type != "cuda" or not mel.is_contiguous():
        raise ValueError(f"no kernel for a {mel.device} / non-contiguous mel")
    out = torch.empty(mel.shape, dtype=out_dtype, device=mel.device)
    rows, frames = mel.shape[0] * mel.shape[1], mel.shape[2]
    with torch.cuda.device(mel.device):
        _check(_library().ff_pcen(
            mel.data_ptr(), rows, frames, *pcen_params, out.data_ptr(),
            int(out_dtype == torch.bfloat16), _stream(),
        ), "pcen")
    profiling.count("fused_featurizer", "fused_featurizer_pcen")
    return out
