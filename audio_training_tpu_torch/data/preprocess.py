"""Batch preprocessing on the device, raw waveform to model input (port of
``audio_training_tpu/data/preprocess.py:25-201``): what the reference
spreads over five tf.data maps (mixup -> normalize -> stft -> mel ->
channel repeat, tfdataset.py:461-505), the dual-badwinner2 views and the
merge model's three-input batches.

Training batches are featurized by K1's ``"default"`` tier (bf16 DFT
products, the CUDA tensor-core kernel on the card), eval batches by the
exact ``"highest"`` tier, as in the JAX package.  ``backend="auto"`` on the
CPU takes the exact rfft path for both, as the JAX package's CPU path
computes f32; ``backend="fused"`` reaches the kernels' plain versions there.
The dual views run K2 (``ops/features.DualMel``) for train and eval batches.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.ops.features import (
    DualMel,
    apply_mix,
    build_mel_weights,
    mix_labels,
    mix_up,
    normalize_rows,
    sample_mix_weights,
    spec_augment,
)
from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
from audio_training_tpu_torch.utils.profiling import setup_span, span


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def dual_configs(cfg: FeaturizerConfig
                 ) -> tuple[FeaturizerConfig, FeaturizerConfig]:
    """dual-badwinner2's two view geometries as the JAX package builds them
    from ``cfg`` (tfdataset.raw_to_mel_dual): 2048/278 up to
    ``min(fmax, 3000)``, and 1024/280 from ``max(fmin, 500)``."""
    common = dict(sr=cfg.sr, segment_length=cfg.segment_length,
                  segment_stride=cfg.segment_stride, n_mels=cfg.n_mels,
                  break_freq=cfg.break_freq)
    return (FeaturizerConfig(n_fft=2048, hop_length=278, fmin=cfg.fmin,
                             fmax=min(cfg.fmax, 3000.0), **common),
            FeaturizerConfig(n_fft=1024, hop_length=280,
                             fmin=max(cfg.fmin, 500.0), fmax=cfg.fmax,
                             **common))


def make_dual_mel(cfg: FeaturizerConfig,
                  device: str | torch.device = "cuda") -> DualMel:
    """The two band-limited views of :func:`dual_configs`, each band the
    config's own ``[fmin, fmax]``."""
    cfg_a, cfg_b = dual_configs(cfg)
    return DualMel(
        build_mel_weights(cfg_a), build_mel_weights(cfg_b), sr=cfg.sr,
        params_a=(cfg_a.n_fft, cfg_a.hop_length),
        params_b=(cfg_b.n_fft, cfg_b.hop_length),
        band_a=(cfg_a.fmin, cfg_a.fmax), band_b=(cfg_b.fmin, cfg_b.fmax),
        device=device)


@setup_span("setup.make_preprocess_fn")
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
    mixup(alpha=0.5) -> per-sample waveform min-max normalize -> raw->mel,
    then with ``use_spec_augment`` SpecAugment masks on the image, drawn
    from the same generator after the mixup weights.  Eval batches are
    normalized too, as the JAX package does (the model trains on
    normalized images and deployment normalizes every window).

    ``dual=True`` emits the dual-badwinner2 pair of views (:func:`make_dual_mel`)
    instead of one image, with no dB, mean subtraction, channel repeat or
    SpecAugment, as in the JAX package."""
    if dual:
        mel_fn = make_dual_mel(cfg, device=device)
    else:
        mel_fn = make_mel_fn(cfg, backend=backend, device=device,
                             precision="default" if augment else "highest")

    def to_image(raw: torch.Tensor):
        if dual:
            return mel_fn(raw)  # (view_a, view_b) images
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
            with span("preprocess"):
                mixed, y = mix_up(
                    generator, _tensor(raw, device), _tensor(y, device),
                    _tensor(raw2, device), _tensor(y2, device),
                    alpha=mixup_alpha, chance=mixup_chance,
                    single_label=single_label_mix,
                )
                mel = to_image(normalize_rows(mixed))
                if use_spec_augment and not dual:
                    mel = spec_augment(generator, mel)
                return mel, y

        return preprocess

    def preprocess_eval(raw, y):
        with span("preprocess"):
            return (to_image(normalize_rows(_tensor(raw, device))),
                    _tensor(y, device))

    return preprocess_eval


def make_merge_preprocess_fn(
    cfg: FeaturizerConfig,
    augment: bool = False,
    mixup_alpha: float = 0.5,
    mixup_chance: float = 0.25,
    single_label_mix: bool = True,
    device: str | torch.device = "cuda",
) -> Callable:
    """Preprocess for the ``merge`` model's three-input tuple ``(mel,
    short_f, mid_f)`` (audiomodel.py:674-708; the features parse at
    tfdataset.py:1103-1119 and pass normalize / raw_to_mel untouched).

    Batches are ``((raw, short_f, mid_f), y[, (raw2, short2, mid2), y2,
    generator])``.  Under augmentation one mixup lambda per sample mixes
    the waveform, both feature tensors and the label (the JAX package's
    joint-training extension of the reference's waveform mixup); the mixed
    waveform is normalized and featurized by :func:`make_mel_fn`, K1's
    ``"default"`` tier for train batches and its exact tier for eval
    batches on the card.  The image is ``(B, n_mels, frames, 1)``."""
    mel_fn = make_mel_fn(cfg, device=device,
                         precision="default" if augment else "highest")

    def to_image(raw: torch.Tensor) -> torch.Tensor:
        return mel_fn(normalize_rows(raw))[..., None]

    if augment:

        def preprocess(xs, y, xs2, y2, generator: torch.Generator):
            raw1, short1, mid1 = (_tensor(a, device) for a in xs)
            raw2, short2, mid2 = (_tensor(a, device) for a in xs2)
            l = sample_mix_weights(generator, raw1.shape[0],
                                   alpha=mixup_alpha, chance=mixup_chance)
            y = mix_labels(l, _tensor(y, device), _tensor(y2, device),
                           single_label=single_label_mix)
            return (to_image(apply_mix(l, raw1, raw2)),
                    apply_mix(l, short1, short2),
                    apply_mix(l, mid1, mid2)), y

        return preprocess

    def preprocess_eval(xs, y):
        raw, short, mid = (_tensor(a, device) for a in xs)
        # eval waveforms normalized like train and deployment, as in
        # make_preprocess_fn's eval path
        return (to_image(raw), short, mid), _tensor(y, device)

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
