"""Fused waveform -> mel power [-> PCEN] featurizer: the CUDA kernel
``csrc/fused_featurizer.cu`` and its plain PyTorch version.

Port of ``audio_training_tpu/ops/pallas/fused_featurizer.py``
(``_featurizer_kernel`` and ``FusedFeaturizer``).  For a CUDA tensor
``FusedFeaturizer.__call__`` launches the kernel (one launch for mel power,
a second for the PCEN epilogue) or raises; for a CPU tensor it computes
:func:`fused_featurizer_plain` — tf-stft framing, ``torch.fft.rfft``,
power, an ``einsum`` with the mel weights and the ``ops.pcen`` pointwise
math.  The batch-global PCEN min-max runs in torch on the output in both
cases, in the output's dtype, as in the JAX class (``:869-872``).

Ported modes: mel power and PCEN with tf ``pad_end`` framing or the
centered (librosa) framing of the long-recording Predictor
(``center=True``), any hop and frame count, f32 or bf16 output, the exact
f32 ``"highest"`` tier; the ``"default"`` tier (bf16 DFT products, f32
sums: the training featurizer) in tf framing, by a second, tensor-core
kernel whose plain version is :func:`mel_power_bf16`; and the
``"bf16_3x"`` / ``"bf16_3x_manual"`` tiers (each DFT product as three bf16
passes over hi/lo splits) in tf framing, by a third tensor-core kernel
whose plain version is :func:`mel_power_bf16_3x`.  The two 3x names differ
on the TPU only in where the constant operator is split; here both launch
the same kernel.  ``"default"`` or ``"bf16_3x*"`` with ``center=True``,
``normalize_waveform`` and ``frontend_params`` raise ``ValueError``;
ROADMAP.md queues them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_training_tpu_torch.ops.cuda.build import load_library
from audio_training_tpu_torch.ops.features import mel_power
from audio_training_tpu_torch.ops.pcen import normalize_minmax_global, pcen
from audio_training_tpu_torch.ops.stft import (
    hann_window,
    num_frames_centered,
    num_frames_tf,
)

N_FFT = 4096
MAX_BINS = 1024  # bins 0..1023: the kernel computes no bin above these
R1, R2 = 32, 128  # "default" tier: n = 128 n1 + n2, k = k1 + 32 k2
PRECISIONS = ("highest", "default", "bf16_3x", "bf16_3x_manual")
_DEFERRED = "ROADMAP.md queue item 1 (K1's remaining modes)"

# Launches of each kernel since the last reset, counted where they launch;
# the "highest" mel kernel is counted by framing mode.
_LAUNCHES = {"fused_featurizer_mel": 0, "fused_featurizer_mel_centered": 0,
             "fused_featurizer_mel_bf16": 0, "fused_featurizer_mel_bf16x3": 0,
             "fused_featurizer_pcen": 0}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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
        ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, ptr, i32, ptr,
    ]
    lib.ff_mel_power.restype = i32
    lib.ff_mel_bf16.argtypes = [
        ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, ptr, i32, ptr,
    ]
    lib.ff_mel_bf16.restype = i32
    lib.ff_mel_bf16x3.argtypes = lib.ff_mel_bf16.argtypes
    lib.ff_mel_bf16x3.restype = i32
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


def _complex_table(z: np.ndarray, device) -> torch.Tensor:
    """Complex values as an (n, 2) f32 tensor (the kernel's float2)."""
    pairs = np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return torch.as_tensor(pairs, device=device)


def _band_tables(mel_weights: np.ndarray) -> tuple[np.ndarray, ...]:
    """Each filter's contiguous band of non-zero bins: start, length,
    offset into the flat weights, and the flat weights."""
    starts, lengths, flat = [], [], []
    for row in np.asarray(mel_weights, np.float32):
        nz = np.flatnonzero(row > 0)
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        starts.append(lo)
        lengths.append(hi - lo)
        flat.append(row[lo:hi])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return (np.asarray(starts, np.int32), np.asarray(lengths, np.int32),
            offsets.astype(np.int32), np.concatenate(flat).astype(np.float32))


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


def mel_power_bf16_3x(raw: torch.Tensor, mel_weights: torch.Tensor,
                      hop: int) -> torch.Tensor:
    """The plain version of the ``"bf16_3x"`` tier kernel: (B, samples)
    f32 -> (B, n_mels, frames) f32 mel power, tf ``pad_end`` framing.  Each
    DFT product x . w is hi(w) hi(x) + lo(w) hi(x) + hi(w) lo(x) at the
    kernel's split points (the windowed samples x * hann, the f32 stage-1
    planes; the operators of :func:`dft_tables_split`), every sum f32
    (``einsum`` of bf16 values held as f32: each product is exact), power
    ``re^2 + im^2`` in f32 and the mel product with f32 weights."""
    dev = raw.device
    tab = {part: {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
           for part, t in dft_tables_split().items()}
    batch, n = raw.shape
    frames = num_frames_tf(n, hop)
    pad = (frames - 1) * hop + N_FFT - n
    framed = F.pad(raw, (0, max(pad, 0))).unfold(-1, N_FFT, hop)
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
                   hop: int) -> torch.Tensor:
    """The plain version of the ``"default"`` tier kernel: (B, samples) f32
    -> (B, n_mels, frames) f32 mel power, tf ``pad_end`` framing, with the
    kernel's decomposition and its six bf16 rounding points (windowed
    samples, stage-1 operator, stage-1 planes, stage-2 operator, power, mel
    weights) and f32 sums (``einsum`` of bf16 values held as f32: each
    product is exact).  Bins past 1023 carry no mel weight
    (:func:`geometry_error`)."""
    dev = raw.device
    tab = {k: torch.as_tensor(v, device=dev)
           for k, v in dft_tables_bf16().items()}
    batch, n = raw.shape
    frames = num_frames_tf(n, hop)
    pad = (frames - 1) * hop + N_FFT - n
    framed = F.pad(raw, (0, max(pad, 0))).unfold(-1, N_FFT, hop)
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


class _Tier(NamedTuple):
    """A tensor-core tier's kernel: its C entry point, its launch counter,
    its operator fragments and whether its mel weights are rounded to
    bf16."""
    entry: str
    counter: str
    fragments: Callable[[], tuple[np.ndarray, np.ndarray]]
    bf16_mel: bool


# the tiers other than the exact "highest"; both 3x names launch one kernel
_TENSOR_CORE = {
    "default": _Tier("ff_mel_bf16", "fused_featurizer_mel_bf16",
                     dft_fragments, True),
    "bf16_3x": _Tier("ff_mel_bf16x3", "fused_featurizer_mel_bf16x3",
                     dft_fragments_x3, False),
}
_TENSOR_CORE["bf16_3x_manual"] = _TENSOR_CORE["bf16_3x"]


def mel_counter(precision: str, center: bool = False) -> str:
    """The launch counter of the mel kernel that ``precision`` launches."""
    if precision in _TENSOR_CORE:
        return _TENSOR_CORE[precision].counter
    return ("fused_featurizer_mel_centered" if center
            else "fused_featurizer_mel")


def fused_featurizer_plain(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    hop: int,
    pcen_params: tuple[float, float, float, float, float] | None = None,
    out_dtype: torch.dtype = torch.float32,
    center: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """The plain version of the kernels: (B, samples) f32 -> (B, n_mels,
    frames) mel power, or the un-normalized PCEN image when ``pcen_params
    = (gain, bias, root, smooth, eps)``, converted to ``out_dtype``;
    ``center`` selects the centered framing, ``precision="default"`` the
    bf16 tier (:func:`mel_power_bf16`), ``"bf16_3x"`` or
    ``"bf16_3x_manual"`` the three-pass tier (:func:`mel_power_bf16_3x`),
    both tf framing only."""
    if precision == "default":
        out = mel_power_bf16(raw, mel_weights, hop)
    elif precision in ("bf16_3x", "bf16_3x_manual"):
        out = mel_power_bf16_3x(raw, mel_weights, hop)
    else:
        out = mel_power(raw, mel_weights, N_FFT, hop, center=center)
    if pcen_params is not None:
        out = pcen(out, *pcen_params, time_axis=2, normalize=False)
    return out.to(out_dtype)


class FusedFeaturizer:
    """Waveform -> PCEN'd (or raw) mel, one kernel per batch (two with
    PCEN).  Parity contracts as in the JAX class: mel power matches the
    tf-stft rfft path, PCEN matches ``ops.pcen.pcen`` including the frame-0
    EMA seed and the batch-global min-max.  ``center=True`` frames as
    ``ops.stft.stft_centered`` does (pad 2048 zeros both sides, ``1 +
    n//hop`` frames), in the kernel without a padded copy."""

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
                f"precision {precision!r}: the ported tiers are "
                f"{PRECISIONS}; the others come with {_DEFERRED}"
            )
        if precision != "highest" and center:
            raise ValueError(
                f"precision {precision!r} with center=True comes with "
                f"{_DEFERRED}"
            )
        self.hop = hop
        self.center = center
        self.precision = precision
        self.n_mels = mel_weights.shape[0]
        self.pcen_params = (gain, bias, root, smooth, eps)
        self.mel_weights = torch.as_tensor(
            np.asarray(mel_weights, np.float32), device=device
        )
        self.device = self.mel_weights.device  # "cuda" resolved to "cuda:N"
        start, length, offset, flat = _band_tables(mel_weights)
        self.n_bins = int((start + length).max())
        to_dev = functools.partial(torch.as_tensor, device=self.device)
        self.band_start, self.band_len = to_dev(start), to_dev(length)
        self.band_off, self.band_w = to_dev(offset), to_dev(flat)
        self.window = to_dev(hann_window(N_FFT))
        # radix-2 stage s (half-span h = 2^s) uses exp(-2 pi i p / 2h),
        # p < h, stored at h - 1; the untangle uses exp(-2 pi i k / 4096)
        stage = np.concatenate([
            np.exp(-2j * np.pi * np.arange(h) / (2 * h))
            for h in (1 << s for s in range(11))
        ])
        self.stage_tw = _complex_table(stage, self.device)
        self.post_tw = _complex_table(
            np.exp(-2j * np.pi * np.arange(MAX_BINS) / N_FFT), self.device
        )
        tier = _TENSOR_CORE.get(precision)
        if tier is not None:
            # the tier's operators in fragment order (stage 2: 1 MB for
            # "default", 2 MB of hi/lo for "bf16_3x")
            d1, op2 = tier.fragments()
            self.d1_frag = to_dev(d1.view(np.int32))
            self.op2_frag = to_dev(op2.view(np.int32))
            if tier.bf16_mel:
                self.band_w = to_dev(round_bf16(flat))

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

        ``out_dtype=torch.bfloat16`` is the f32 result converted at the
        store: bitwise the cast of the f32 output (for ``normalize=False``
        paths; the PCEN min-max then runs in bf16 on the bf16 output)."""
        if normalize_waveform or frontend_params is not None:
            raise ValueError(
                "normalize_waveform / frontend_params (the in-kernel "
                f"folds) come with {_DEFERRED}"
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
        if raw.device.type == "cpu":
            out = fused_featurizer_plain(
                raw, self.mel_weights, self.hop, params, out_dtype,
                self.center, self.precision,
            )
        else:
            out = self._launch(raw, params, out_dtype)
        if pcen and normalize:
            out = normalize_minmax_global(out)
        return out

    def _launch(self, raw, pcen_params, out_dtype) -> torch.Tensor:
        if raw.device.type != "cuda":
            raise ValueError(f"no kernel for device {raw.device}")
        if not raw.is_contiguous():
            raise ValueError("raw must be contiguous")
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
        tier = _TENSOR_CORE.get(self.precision)
        if tier is not None:
            with torch.cuda.device(raw.device):
                _check(getattr(_library(), tier.entry)(
                    raw.data_ptr(), batch, samples, self.hop, frames,
                    self.window.data_ptr(), self.d1_frag.data_ptr(),
                    self.op2_frag.data_ptr(), self.band_start.data_ptr(),
                    self.band_len.data_ptr(), self.band_off.data_ptr(),
                    self.band_w.data_ptr(), self.n_mels, mel.data_ptr(),
                    int(mel_dtype == torch.bfloat16), _stream(),
                ), f"{self.precision} mel")
            _LAUNCHES[tier.counter] += 1
            return mel if pcen_params is None else pcen_rows(
                mel, pcen_params, out_dtype)
        with torch.cuda.device(raw.device):
            _check(_library().ff_mel_power(
                raw.data_ptr(), batch, samples, self.hop, left_pad, frames,
                self.window.data_ptr(), self.stage_tw.data_ptr(),
                self.post_tw.data_ptr(), self.band_start.data_ptr(),
                self.band_len.data_ptr(), self.band_off.data_ptr(),
                self.band_w.data_ptr(), self.n_mels, self.n_bins,
                mel.data_ptr(), int(mel_dtype == torch.bfloat16),
                _stream(),
            ), "mel power")
        _LAUNCHES[mel_counter(self.precision, self.center)] += 1
        if pcen_params is None:
            return mel
        return pcen_rows(mel, pcen_params, out_dtype)


def pcen_rows(
    mel: torch.Tensor,
    pcen_params: tuple[float, float, float, float, float],
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The PCEN epilogue on a (B, M, T) f32 mel power: the un-normalized
    PCEN image in ``out_dtype``.  On CUDA the kernel runs one thread per
    (clip, mel) row walking the frames; on the CPU the plain version,
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
    _LAUNCHES["fused_featurizer_pcen"] += 1
    return out
