"""Long-recording prediction: detection -> windows -> featurize and classify
on the card -> per-track aggregation (port of
``audio_training_tpu/infer/predictor.py``).

The reference runs ``model.predict`` per track (predict.main,
predict.py:726-997); here every window of every track goes through the
model in batches of ``InferenceConfig.max_window_batch``, and mean/max/votes
aggregation is a segment reduction keyed by track index.

The featurizer is chosen from the geometry, before anything launches:

* ``n_fft == 4096`` with the filterbank inside bins 0..1023
  (``ops.cuda.fused_featurizer.geometry_error`` is None): the fused
  featurizer kernel (K1) in its centered mode, one launch per batch;
* any other geometry: ``ops.stft.stft_centered`` (``torch.fft.rfft``) and
  then the power-mel kernel (K2, ``ops.cuda.melspec``) on the complex STFT.

On a CUDA device both wrappers launch their kernels or raise; on the CPU
they compute their plain versions, so the CPU runs the same two paths.

With a data-parallel ``mesh`` (JAX ``infer/predictor.py:78-85``,
``:174-188``) the weights are broadcast from rank 0, each window batch is
padded up to a multiple of the mesh's ranks, every rank featurizes and
classifies its rows, and the probabilities are gathered, so that every
rank returns the full ``(n, labels)`` array.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from audio_training_tpu_torch.config import FeaturizerConfig, InferenceConfig
from audio_training_tpu_torch.detect import (
    get_end,
    get_tracks_from_signals,
    signal_noise,
)
from audio_training_tpu_torch.infer.windows import (
    bucket_pad,
    extract_track_windows,
)
from audio_training_tpu_torch.ops.cuda.fused_featurizer import (
    FusedFeaturizer,
    geometry_error,
)
from audio_training_tpu_torch.ops.cuda.melspec import fused_power_mel_complex
from audio_training_tpu_torch.ops.features import (
    build_mel_weights,
    normalize_rows,
)
from audio_training_tpu_torch.ops.stft import stft_centered
from audio_training_tpu_torch.parallel.collectives import gather_rows
from audio_training_tpu_torch.parallel.mesh import replicated, shard_batch


@dataclass
class ModelResult:
    """Per-track aggregated prediction (predict.ModelResult,
    predict.py:1103-1126)."""

    model: str
    labels: list[str] = field(default_factory=list)
    confidences: list[int] = field(default_factory=list)
    raw_tag: str | None = None
    raw_confidence: int | None = None
    clarity: float | None = None

    def get_meta(self) -> dict:
        meta = {"model": self.model, "labels": self.labels,
                "confidences": self.confidences}
        if self.raw_tag is not None:
            meta["raw_tag"] = self.raw_tag
            meta["raw_confidence"] = self.raw_confidence
        return meta


class Predictor:
    """Inference engine for one trained model.  ``module`` returns logits
    (built with ``logits_only=True``), holds its weights on ``device`` and
    is put in eval mode.  With a ``mesh`` of more than one rank
    (``parallel.make_mesh``), ``device`` is the mesh's and every rank calls
    the Predictor with the same windows."""

    def __init__(
        self,
        module: nn.Module,
        labels: list[str],
        cfg: FeaturizerConfig,
        infer_cfg: InferenceConfig | None = None,
        model_name: str = "model",
        channels: int = 1,
        mean_sub: bool = False,
        db_scale: bool = False,
        multi_label: bool = True,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            device = self.mesh.device
            replicated(self.mesh)(module)
        self.module = module.eval()
        self.labels = list(labels)
        self.cfg = cfg
        self.infer_cfg = infer_cfg or InferenceConfig()
        self.model_name = model_name
        self.channels = channels
        self.mean_sub = mean_sub
        self.db_scale = db_scale
        self.multi_label = multi_label
        mel_w = build_mel_weights(cfg)
        if geometry_error(mel_w, cfg.n_fft) is None:
            self._fused = FusedFeaturizer(mel_w, cfg.n_fft, cfg.hop_length,
                                          center=True, device=device)
            self.device = self._fused.device
        else:
            self._fused = None
            self._mel_w_t = torch.as_tensor(np.ascontiguousarray(mel_w.T),
                                            device=device)
            self.device = self._mel_w_t.device

    def featurize(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, samples) f32 windows -> (B, n_mels, frames) f32 mel power,
        the inference convention (predict_utils.get_spect): per-window
        min-max normalize, centered STFT, power-2 mel."""
        raw = normalize_rows(raw)
        if self._fused is not None:
            return self._fused(raw, pcen=False)
        spec = stft_centered(raw, self.cfg.n_fft, self.cfg.hop_length)
        # (B, F, T) is a view of the contiguous time-major (B, T, F) spectrum
        mel = fused_power_mel_complex(spec.transpose(1, 2), self._mel_w_t)
        return mel.transpose(1, 2)

    def classify(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, frames) mel power -> (B, labels) probabilities."""
        if self.db_scale:
            # per-sample dB reference (the reference applies
            # librosa.power_to_db per clip, predict_utils.py:216-217; a
            # batch-global max would couple predictions to batch
            # composition and to padding rows)
            amin = 1e-10
            ref_v = mel.amax(dim=(1, 2), keepdim=True)
            out_db = 10.0 * torch.log10(mel.clamp(min=amin))
            out_db = out_db - 10.0 * torch.log10(ref_v.clamp(min=amin))
            mel = torch.maximum(
                out_db, out_db.amax(dim=(1, 2), keepdim=True) - 80.0)
        if self.mean_sub:
            mel = mel - mel.mean(dim=2, keepdim=True)
        x = mel[..., None]
        if self.channels > 1:
            x = x.repeat_interleave(self.channels, dim=-1)
        out = self.module(x)
        if self.multi_label:
            return torch.sigmoid(out)
        return torch.softmax(out, dim=-1)

    @torch.no_grad()
    def predict_windows(self, windows: np.ndarray) -> np.ndarray:
        """Classify (N, samples) windows, N padded to a bucket so that the
        batches take a few shapes only."""
        n = windows.shape[0]
        if n == 0:
            return np.zeros((0, len(self.labels)), np.float32)
        padded = bucket_pad(n, self.infer_cfg.bucket_sizes)
        if self.mesh is not None:
            # the batch axis must divide the mesh (JAX pads to its devices)
            shards = self.mesh.size
            padded = -(-padded // shards) * shards
        if padded != n:
            # pad by repeating the last real window: all-zero rows would
            # turn into NaN under the per-window min-max normalize
            pad_rows = np.repeat(windows[-1:], padded - n, axis=0)
            windows = np.concatenate([windows, pad_rows])
        out = []
        cap = self.infer_cfg.max_window_batch
        for i in range(0, padded, cap):
            chunk = torch.as_tensor(windows[i : i + cap], dtype=torch.float32)
            if self.mesh is None:
                probs = self.classify(self.featurize(chunk.to(self.device)))
            else:
                # a chunk the data axis does not divide raises, as JAX's
                # device_put of it does
                with self.mesh:
                    probs = gather_rows(self.mesh, self.classify(
                        self.featurize(shard_batch(self.mesh, chunk))))
            out.append(probs.cpu().numpy())
        return np.concatenate(out)[:n]

    def predict_recording(
        self,
        frames: np.ndarray,
        sr: int,
        tracks: list | None = None,
        threshold: float | np.ndarray | None = None,
    ):
        """Full pipeline: [detect tracks] -> windows -> classify ->
        aggregate.  Returns (tracks, per-track ModelResult list)."""
        threshold = threshold if threshold is not None else self.infer_cfg.threshold
        if tracks is None:
            end = get_end(frames, sr)
            signals, _ = signal_noise(frames, sr)
            tracks = get_tracks_from_signals(signals, end)
        batch = extract_track_windows(
            frames, sr, tracks,
            segment_length=self.cfg.segment_length,
            stride=self.cfg.segment_stride,
            fmin=self.cfg.fmin, fmax=self.cfg.fmax,
        )
        probs = self.predict_windows(batch.windows)
        results = aggregate_tracks(
            probs, batch.track_index, len(tracks), self.labels,
            threshold=threshold, model_name=self.model_name,
            mode=self.infer_cfg.aggregation,
        )
        for t, r in zip(tracks, results):
            if r is not None:
                t.predictions.append(r)
        return tracks, results


def aggregate_tracks(
    probs: np.ndarray,
    track_index: np.ndarray,
    num_tracks: int,
    labels: list[str],
    threshold: float | np.ndarray = 0.7,
    model_name: str = "model",
    mode: str = "mean",
) -> list[ModelResult | None]:
    """Aggregate window probabilities per track.

    ``mean``: average over windows, then threshold (predict.py:930-956).
    ``max``: per-label max over windows.
    ``votes``: count windows whose argmax clears the threshold, label wins
    with any votes (audiomodel.evaluate_dir count path, :1888-1933).
    Tracks with no windows (skipped/out-of-band) get ``None``.

    ``threshold`` may be a per-label vector — the reference ships a
    hard-coded per-class threshold table clipped to [0.5, 0.9] and applies
    it at predict time (preeval.py:143-221, predict.py:503).
    """
    thr = np.broadcast_to(np.asarray(threshold, np.float32),
                          (len(labels),)).copy()
    results: list[ModelResult | None] = []
    for ti in range(num_tracks):
        mask = track_index == ti
        if not mask.any():
            results.append(None)
            continue
        p = probs[mask]
        result = ModelResult(model_name)
        if mode == "max":
            agg = p.max(axis=0)
        elif mode == "votes":
            counts = np.zeros(len(labels))
            for row in p:
                mi = int(row.argmax())
                if row[mi] >= thr[mi]:
                    counts[mi] += 1
            mean = p.mean(axis=0)
            for i, c in enumerate(counts):
                if c > 0:
                    result.labels.append(labels[i])
                    result.confidences.append(round(float(mean[i]) * 100))
            if not result.labels:
                mi = int(mean.argmax())
                result.raw_tag = labels[mi]
                result.raw_confidence = round(float(mean[mi]) * 100)
            results.append(result)
            continue
        else:
            agg = p.mean(axis=0)
        max_i = int(agg.argmax())
        for i, v in enumerate(agg):
            if v >= thr[i]:
                result.labels.append(labels[i])
                result.confidences.append(round(float(v) * 100))
        if not result.labels:
            result.raw_tag = labels[max_i]
            result.raw_confidence = round(float(agg[max_i]) * 100)
        results.append(result)
    return results
