"""Fused waveform -> mel [-> PCEN] -> CNN inference (port of
``audio_training_tpu/infer/fused.py:24-57``).

The featurizer is the CUDA kernel on a CUDA device at the production
geometry and the plain rfft path elsewhere (``ops.featurizer_select``); the
model runs in whatever compute dtype it was built with.  As in the JAX
function, the waveform is not normalized here.  The official benchmark
chain (bench.py:262-310) is ``BackboneClassifier(mobilenet,
external_frontend=True)`` in bf16 behind ``use_pcen=True, channels=3,
out_dtype=torch.bfloat16``: the kernel's PCEN epilogue writes the bf16
image the CNN reads.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
from audio_training_tpu_torch.utils.profiling import setup_span, span


@setup_span("setup.make_fused_infer_fn")
def make_fused_infer_fn(
    module: nn.Module,
    cfg: FeaturizerConfig,
    use_pcen: bool = False,
    use_kernel: bool = True,
    channels: int = 1,
    probabilities: bool = False,
    precision: str = "highest",
    device: str | torch.device = "cuda",
    out_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor | np.ndarray], torch.Tensor]:
    """Build fn: raw (B, samples) float32 -> logits/probs (B, L).

    ``module`` holds its weights on ``device`` and is put in eval mode.
    ``use_kernel=False`` forces the plain rfft + einsum featurizer;
    otherwise the backend is chosen from the geometry and the device.
    ``precision`` is the featurizer kernel's tier (``"highest"``,
    ``"default"``, ``"bf16_3x"``, ``"bf16_3x_manual"``); ``out_dtype`` the
    dtype of the image the featurizer hands the model.
    """
    mel_fn = make_mel_fn(cfg, backend="auto" if use_kernel else "rfft",
                         precision=precision, device=device, pcen=use_pcen,
                         out_dtype=out_dtype)
    module.eval()

    @torch.no_grad()
    def infer(raw: torch.Tensor | np.ndarray) -> torch.Tensor:
        with span("infer"):
            raw = torch.as_tensor(raw, dtype=torch.float32, device=device)
            x = mel_fn(raw)[..., None]  # (B, M, T, 1), NHWC
            if channels > 1:
                x = x.repeat_interleave(channels, dim=-1)
            out = module(x)
            if probabilities:
                out = torch.sigmoid(out)
            return out

    return infer
