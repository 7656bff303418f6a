"""Spectral-gating denoise (port of ``audio_training_tpu/ops/denoise.py``;
reference: predict.denoise_spec, predict.py:125-184): estimate a
per-frequency noise profile from the quietest frames, build a soft
time-frequency mask, resynthesize.

Plain PyTorch on the waveform's device: the JAX module computes it with
``jnp`` outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import torch

from audio_training_tpu_torch.ops.stft import istft_centered, stft_centered


def spectral_gate(
    x: torch.Tensor,
    n_fft: int = 2048,
    hop: int = 512,
    n_std: float = 1.5,
    noise_frames: int = 32,
    length: int | None = None,
) -> torch.Tensor:
    """Denoise (B, samples) waveforms by gating bins below
    ``noise_mean + n_std * noise_std`` of the quietest frames' profile."""
    if length is None:
        length = x.shape[-1]
    spec = stft_centered(x, n_fft, hop)  # (B, F, T)
    mag = spec.abs()
    # noise profile: the lowest-energy frames; JAX's argsort is stable and
    # its std the population std
    frame_energy = mag.sum(dim=1)  # (B, T)
    order = torch.argsort(frame_energy, dim=-1, stable=True)[:, :noise_frames]
    quiet = torch.take_along_dim(mag, order[:, None, :], dim=2)
    noise_mean = quiet.mean(dim=2, keepdim=True)
    noise_std = quiet.std(dim=2, keepdim=True, correction=0)
    thresh = noise_mean + n_std * noise_std
    # soft sigmoid mask around the threshold
    mask = torch.sigmoid((mag - thresh) / (thresh + 1e-8) * 4.0)
    return istft_centered(spec * mask, n_fft, hop, length)
