"""Fused waveform -> mel [-> PCEN] -> CNN inference (port of
``audio_training_tpu/infer/fused.py:24-57``).

The featurizer is the CUDA kernel on a CUDA device at the production
geometry and the plain rfft path elsewhere (``ops.featurizer_select``); the
model runs in whatever compute dtype it was built with.  As in the JAX
function, the waveform is not normalized here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn


def make_fused_infer_fn(
    module: nn.Module,
    cfg: FeaturizerConfig,
    use_pcen: bool = False,
    use_kernel: bool = True,
    channels: int = 1,
    probabilities: bool = False,
    precision: str = "highest",
    device: str | torch.device = "cuda",
) -> Callable[[torch.Tensor | np.ndarray], torch.Tensor]:
    """Build fn: raw (B, samples) float32 -> logits/probs (B, L).

    ``module`` holds its weights on ``device`` and is put in eval mode.
    ``use_kernel=False`` forces the plain rfft + einsum featurizer;
    otherwise the backend is chosen from the geometry and the device.
    """
    mel_fn = make_mel_fn(cfg, backend="auto" if use_kernel else "rfft",
                         precision=precision, device=device, pcen=use_pcen)
    module.eval()

    @torch.no_grad()
    def infer(raw: torch.Tensor | np.ndarray) -> torch.Tensor:
        raw = torch.as_tensor(raw, dtype=torch.float32, device=device)
        x = mel_fn(raw)[..., None]  # (B, M, T, 1)
        if channels > 1:
            x = x.repeat_interleave(channels, dim=-1)
        out = module(x)
        if probabilities:
            out = torch.sigmoid(out)
        return out

    return infer
