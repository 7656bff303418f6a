"""Short-time Fourier transforms (port of
``audio_training_tpu/ops/stft.py:28-99``).

``stft_tf_style`` reproduces ``tf.signal.stft(x, n_fft, hop,
fft_length=n_fft, pad_end=True)``, the training pipeline's framing
(``tfdataset.py:2026-2034``): frame ``t`` starts at sample ``t*hop`` and the
tail is zero-padded, so there are ``ceil(n/hop)`` frames (513 for 3 s at
48 kHz, hop 281) and the last ones read past the clip into zeros.

``stft_centered`` is librosa's centered convention, used by the
long-recording Predictor: the signal is padded with ``n_fft//2`` zeros on
both sides and there are ``1 + n//hop`` frames.

Both are built from ``unfold`` and ``torch.fft.rfft``; ``torch.stft``
frames differently and is not used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window — matches ``tf.signal.hann_window`` and
    librosa's default ``get_window('hann', fftbins=True)``."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


def num_frames_tf(n_samples: int, hop: int) -> int:
    return -(-n_samples // hop)


def num_frames_centered(n_samples: int, hop: int) -> int:
    return 1 + n_samples // hop


def stft_tf_style(x: torch.Tensor, n_fft: int, hop: int,
                  window: bool = True) -> torch.Tensor:
    """Hann-windowed unless ``window=False`` (a rectangular window).
    x: (..., n_samples) real.  Returns (..., frames, n_fft//2+1) complex."""
    n = x.shape[-1]
    frames = num_frames_tf(n, hop)
    pad = (frames - 1) * hop + n_fft - n
    framed = F.pad(x, (0, max(pad, 0))).unfold(-1, n_fft, hop)
    if window:
        framed = framed * torch.as_tensor(hann_window(n_fft), device=x.device)
    return torch.fft.rfft(framed, n=n_fft, dim=-1)


def stft_centered(x: torch.Tensor, n_fft: int, hop: int, window: bool = True,
                  pad_mode: str = "constant") -> torch.Tensor:
    """librosa-style centered STFT, Hann-windowed unless ``window=False``,
    the ``n_fft//2`` edges padded by ``pad_mode`` (numpy's names, as
    ``jnp.pad`` takes them: ``"constant"`` zeros, ``"reflect"``, ``"edge"``
    or ``"wrap"``).  x: (..., n_samples) real.  Returns (..., n_fft//2+1,
    frames) complex — the librosa (freq, time) axis order, as a transposed
    view of the time-major spectrum."""
    half = n_fft // 2
    # unfold gives (n + n_fft - n_fft) // hop + 1 = num_frames_centered
    framed = _pad_edges(x, half, pad_mode).unfold(-1, n_fft, hop)
    if window:
        framed = framed * torch.as_tensor(hann_window(n_fft), device=x.device)
    return torch.fft.rfft(framed, n=n_fft, dim=-1).transpose(-1, -2)


# numpy's pad mode -> torch's F.pad mode
_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate", "wrap": "circular"}


def _pad_edges(x: torch.Tensor, half: int, pad_mode: str) -> torch.Tensor:
    """``half`` samples on both sides of the last axis, as ``jnp.pad(x,
    half, mode=pad_mode)`` gives them."""
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}; one of "
                         f"{sorted(_PAD_MODES)}")
    if pad_mode == "constant":
        return F.pad(x, (half, half))
    # torch's non-constant modes take a batched (N, C, L) input
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (half, half), mode=_PAD_MODES[pad_mode]).reshape(
        *lead, -1)


def istft_centered(spec: torch.Tensor, n_fft: int, hop: int,
                   length: int) -> torch.Tensor:
    """Inverse of :func:`stft_centered` with Hann overlap-add (port of JAX
    ``ops/stft.py:102-122``, the spectral-gating denoise's resynthesis,
    predict.py:125-184).  spec: (..., n_fft//2+1, frames) complex.  Each
    frame's ``irfft`` is windowed and added at ``t*hop``; the sum is divided
    by the overlapping windows' squares where they exceed 1e-10 and cropped
    to ``[n_fft//2, n_fft//2 + length)``.  Returns (..., length) real."""
    frames = spec.shape[-1]
    window = torch.as_tensor(hann_window(n_fft), device=spec.device)
    chunks = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    total = (frames - 1) * hop + n_fft
    lead = chunks.shape[:-2]
    # fold sums the (n_fft, frames) columns at stride hop: the overlap-add
    out = F.fold(chunks.reshape(-1, frames, n_fft).transpose(1, 2),
                 output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop)).reshape(*lead, total)
    # the window-square sum in float64, one vectorized add per hop-wide
    # piece j of the window (row r of the (frames + k, hop) view gets piece
    # j of frame r - j); j descending adds each sample's frames in JAX's
    # increasing-frame order
    k = -(-n_fft // hop)
    w = np.zeros(k * hop)
    w[:n_fft] = hann_window(n_fft).astype(np.float64) ** 2
    rows = np.zeros((frames + k, hop))
    for j in reversed(range(k)):
        rows[j : j + frames] += w[j * hop : (j + 1) * hop]
    win_sum = rows.reshape(-1)[:total]
    win_sum = np.where(win_sum > 1e-10, win_sum, 1.0)
    out = out / torch.as_tensor(win_sum, dtype=out.dtype, device=out.device)
    half = n_fft // 2
    return out[..., half : half + length]
