"""Batch preprocessing on the device, raw waveform to model input (port of
``audio_training_tpu/data/preprocess.py:25-142, 209-251``): what the
reference spreads over five tf.data maps (mixup -> normalize -> stft ->
mel -> channel repeat, tfdataset.py:461-505).

Training batches are featurized by K1's ``"default"`` tier (bf16 DFT
products, the CUDA tensor-core kernel on the card), eval batches by the
exact ``"highest"`` tier, as in the JAX package.  ``backend="auto"`` on the
CPU takes the exact rfft path for both, as the JAX package's CPU path
computes f32; ``backend="fused"`` reaches the kernels' plain versions there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.features import mix_up, normalize_rows
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn

_QUEUED = 'ROADMAP.md queue 1, "Training from a built corpus"'


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def make_preprocess_fn(
    cfg: FeaturizerConfig,
    augment: bool = False,
    mixup_alpha: float = 0.5,
    mixup_chance: float = 0.25,
    single_label_mix: bool = True,
    use_spec_augment: bool = False,
    channels: int = 1,
    dual: bool = False,
    backend: str = "auto",
    device: str | torch.device = "cuda",
) -> Callable:
    """Build ``(raw, y, raw2, y2, generator) -> (mel, y)`` (``augment``) or
    ``(raw, y) -> (mel, y)``.  Batches may be numpy arrays or tensors; they
    are moved to ``device``.  ``mel`` is ``(B, n_mels, frames, channels)``
    f32.

    Augmented path order matches get_dataset (tfdataset.py:466-505):
    mixup(alpha=0.5) -> per-sample waveform min-max normalize -> raw->mel.
    Eval batches are normalized too, as the JAX package does (the model
    trains on normalized images and deployment normalizes every window)."""
    if dual:
        raise NotImplementedError(f"dual preprocess comes with {_QUEUED}")
    if use_spec_augment:
        raise NotImplementedError(f"spec_augment comes with {_QUEUED}")
    mel_fn = make_mel_fn(cfg, backend=backend, device=device,
                         precision="default" if augment else "highest")

    def to_image(raw: torch.Tensor) -> torch.Tensor:
        mel = mel_fn(raw)  # (B, M, T)
        if cfg.db_scale:
            # per-sample dB (matches the inference featurizer)
            amin = 1e-10
            ref_v = mel.amax(dim=(1, 2), keepdim=True)
            out_db = 10.0 * torch.log10(mel.clamp_min(amin))
            out_db = out_db - 10.0 * torch.log10(ref_v.clamp_min(amin))
            mel = torch.maximum(
                out_db, out_db.amax(dim=(1, 2), keepdim=True) - 80.0)
        if cfg.mean_sub:
            mel = mel - mel.mean(dim=2, keepdim=True)
        img = mel[..., None]
        if channels > 1:
            img = img.repeat_interleave(channels, dim=-1)
        return img

    if augment:

        def preprocess(raw, y, raw2, y2, generator: torch.Generator):
            mixed, y = mix_up(
                generator, _tensor(raw, device), _tensor(y, device),
                _tensor(raw2, device), _tensor(y2, device),
                alpha=mixup_alpha, chance=mixup_chance,
                single_label=single_label_mix,
            )
            return to_image(normalize_rows(mixed)), y

        return preprocess

    def preprocess_eval(raw, y):
        return (to_image(normalize_rows(_tensor(raw, device))),
                _tensor(y, device))

    return preprocess_eval


# ---------------------------------------------------------------------------
# Class weighting / distribution (tfdataset.py:315-338, 1721-1761)
# ---------------------------------------------------------------------------


def get_distribution(batches, num_labels: int) -> tuple[np.ndarray, int]:
    """Per-label positive counts + total sample count over an iterable of
    (x, y) batches (tfdataset.get_distribution)."""
    dist = np.zeros(num_labels, np.float64)
    total = 0
    for _, y in batches:
        y = np.asarray(y)
        dist += y.sum(axis=0)
        total += y.shape[0]
    return dist, total


def get_weighting(
    dist: np.ndarray,
    labels: list[str],
    dont_weigh: list[str] | None = None,
    cap_max: float = 4.0,
    cap_min: float = 0.25,
) -> dict[int, float]:
    """Inverse-frequency class weights clipped to [0.25, 4]
    (tfdataset.get_weighting, tfdataset.py:1721-1761)."""
    dont_weigh = dont_weigh or []
    num_labels = len(labels)
    dist = np.asarray(dist, np.float64)
    non_zero = num_labels - int((dist == 0).sum())
    total = sum(d for d, l in zip(dist, labels) if l not in dont_weigh)
    weights: dict[int, float] = {}
    for i in range(num_labels):
        if labels[i] in dont_weigh:
            weights[i] = 1.0
        elif dist[i] == 0:
            weights[i] = 0.0
        else:
            w = (1.0 / dist[i]) * (total / max(non_zero, 1))
            weights[i] = float(np.clip(w, cap_min, cap_max))
    return weights


def weights_to_array(weights: dict[int, float], num_labels: int) -> np.ndarray:
    out = np.ones(num_labels, np.float32)
    for i, w in weights.items():
        out[i] = w
    return out
