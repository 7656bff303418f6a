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
f32 ``"highest"`` tier.  The other precision tiers, ``normalize_waveform``
and ``frontend_params`` raise ``ValueError``; ROADMAP.md queues them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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
_DEFERRED = "ROADMAP.md queue item 1 (K1's remaining modes)"

# Launches of each kernel since the last reset, counted where they launch;
# the mel kernel is counted by framing mode.
_LAUNCHES = {"fused_featurizer_mel": 0, "fused_featurizer_mel_centered": 0,
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


def fused_featurizer_plain(
    raw: torch.Tensor,
    mel_weights: torch.Tensor,
    hop: int,
    pcen_params: tuple[float, float, float, float, float] | None = None,
    out_dtype: torch.dtype = torch.float32,
    center: bool = False,
) -> torch.Tensor:
    """The plain version of the kernel: (B, samples) f32 -> (B, n_mels,
    frames) mel power, or the un-normalized PCEN image when ``pcen_params
    = (gain, bias, root, smooth, eps)``, converted to ``out_dtype``;
    ``center`` selects the centered framing."""
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
        if precision != "highest":
            raise ValueError(
                f"precision {precision!r}: only the exact f32 'highest' tier "
                f"is ported; the others come with {_DEFERRED}"
            )
        self.hop = hop
        self.center = center
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
                raw, self.mel_weights, self.hop, params, out_dtype, self.center
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
        _LAUNCHES["fused_featurizer_mel_centered" if self.center
                  else "fused_featurizer_mel"] += 1
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
