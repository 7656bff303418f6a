"""Featurizer backend selection (port of
``audio_training_tpu/ops/featurizer_select.py:30-72``).

Two implementations of waveform -> (B, M, T) mel power, tf-stft framing:

* ``fused`` — the CUDA kernel (``ops/cuda/fused_featurizer.py``); needs
  n_fft=4096 and filterbank support within bins 0..1023.
* ``rfft`` — plain torch: tf framing + ``torch.fft.rfft`` + power + mel
  ``einsum``; any geometry, any device.  ``matmul`` names the JAX
  package's radix-64 matmul-FFT (an XLA formulation for the TPU's matrix
  unit) and is accepted for its callers: it computes the same function,
  here by the ``rfft`` path.

``auto`` picks ``fused`` for a CUDA device when the geometry allows it and
``rfft`` otherwise.  The choice is made from the geometry and the device,
before anything is launched.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.cuda.fused_featurizer import (
    FusedFeaturizer,
    geometry_error,
)
from audio_training_tpu_torch.ops.features import build_mel_weights, mel_power
from audio_training_tpu_torch.ops.pcen import pcen as pcen_op


def make_mel_fn(
    cfg: FeaturizerConfig,
    mel_weights: np.ndarray | None = None,
    backend: str = "auto",
    precision: str = "highest",
    device: str | torch.device = "cuda",
    pcen: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns fn(raw (B, n)) -> (B, n_mels, frames) mel power, or with
    ``pcen`` the min-max-normalized PCEN image (default PCEN parameters;
    the fused kernel runs it as its epilogue), in ``out_dtype`` (f32 or
    bf16: the fused kernel stores bf16 and normalizes in bf16, as the JAX
    kernel does; the rfft path casts its f32 result)."""
    w = mel_weights if mel_weights is not None else build_mel_weights(cfg)
    if backend == "auto":
        fused_ok = (torch.device(device).type == "cuda"
                    and geometry_error(w, cfg.n_fft) is None)
        backend = "fused" if fused_ok else "rfft"

    if backend == "fused":
        fz = FusedFeaturizer(w, cfg.n_fft, cfg.hop_length,
                             precision=precision, device=device)
        return lambda raw: fz(raw, pcen=pcen, out_dtype=out_dtype)
    if backend in ("rfft", "matmul"):
        w_dev = torch.as_tensor(w, device=device)

        def rfft_mel(raw: torch.Tensor) -> torch.Tensor:
            mel = mel_power(raw, w_dev, cfg.n_fft, cfg.hop_length)
            return (pcen_op(mel, time_axis=2) if pcen else mel).to(out_dtype)

        return rfft_mel
    raise ValueError(f"unknown featurizer backend {backend}")
