"""External embedding models (Perch / YAMNet) and embedding-path inference
(port of ``audio_training_tpu/infer/embeddings.py``).

The reference optionally extracts bird-vocalization-classifier ("Perch")
embeddings at record-write time (audiowriter.py:212,248-253,440-453) and
offers chirp/yamnet embedding + YAMNet speech-score paths at inference
(predict.py:380-396,1051).  Those models are TensorFlow saved models: the
wrappers load a local saved-model path with ``tf.saved_model.load`` inside
``EmbeddingModel.__init__`` (TensorFlow is imported there and nowhere else)
and raise clear errors when it is absent, exactly as the JAX package does.
Embeddings are computed on the host by TensorFlow; the linear probe that
classifies them (``models/registry.LinearEmbeddings``) runs on the
Predictor's torch device.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from audio_training_tpu_torch.config import InferenceConfig
from audio_training_tpu_torch.corpus.audioio import resample
from audio_training_tpu_torch.detect import (
    get_end,
    get_tracks_from_signals,
    signal_noise,
)
from audio_training_tpu_torch.infer.predictor import aggregate_tracks
from audio_training_tpu_torch.infer.windows import extract_track_windows

log = logging.getLogger(__name__)

PERCH_EMBEDDING_DIM = 1280
YAMNET_EMBEDDING_SHAPE = (6, 1024)  # per 3 s window (tfdataset.py:181)


class EmbeddingModel:
    """Wrapper over a locally-available TF-hub style saved model."""

    def __init__(self, model_path: str | Path | None, name: str,
                 sample_rate: int):
        self.name = name
        self.sample_rate = sample_rate
        self._model = None
        if model_path is not None and Path(model_path).exists():
            try:
                import tensorflow as tf

                self._model = tf.saved_model.load(str(model_path))
            except Exception:
                log.error("could not load %s from %s", name, model_path,
                          exc_info=True)

    @property
    def available(self) -> bool:
        return self._model is not None

    def _require(self):
        if self._model is None:
            raise RuntimeError(
                f"{self.name} embedding model is not available: pass a local "
                "saved-model path (tensorflow_hub is unreachable in "
                "zero-egress builds)"
            )


class PerchModel(EmbeddingModel):
    """bird-vocalization-classifier: 5 s 32 kHz windows -> 1280-d embedding
    + logits (audiowriter.py:212-253)."""

    WINDOW_S = 5.0

    def __init__(self, model_path: str | Path | None = None):
        super().__init__(model_path, "perch", 32000)

    def embed(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(windows*160k,) 32 kHz audio -> (windows, 1280) embeddings and
        (windows, classes) logits."""
        self._require()
        window = int(self.WINDOW_S * self.sample_rate)
        n = len(frames) // window
        chunks = frames[: n * window].reshape(n, window)
        out = self._model.infer_tf(chunks.astype(np.float32))
        return np.asarray(out["embedding"]), np.asarray(out["label"])

    def embed_window(self, window: np.ndarray) -> np.ndarray:
        """One window (any length, model rate) -> one embedding vector;
        short windows are zero-padded to the 5 s model window."""
        need = int(self.WINDOW_S * self.sample_rate)
        if len(window) < need:
            window = np.pad(window, (0, need - len(window)))
        emb, _ = self.embed(window[:need])
        return emb[0]


class YamnetModel(EmbeddingModel):
    """YAMNet: 16 kHz waveform -> (frames, 1024) embeddings + 521 scores
    (predict.py:380-396)."""

    def __init__(self, model_path: str | Path | None = None):
        super().__init__(model_path, "yamnet", 16000)

    def embed(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        self._require()
        scores, embeddings, _ = self._model(frames.astype(np.float32))
        return np.asarray(embeddings), np.asarray(scores)

    def speech_score(self, frames: np.ndarray,
                     speech_index: int = 0) -> float:
        """Max speech probability over the clip (predict.get_speech_score,
        predict.py:1051)."""
        _, scores = self.embed(frames)
        return float(np.max(scores[:, speech_index]))

    def embed_window(self, window: np.ndarray) -> np.ndarray:
        """One window -> mean YAMNet embedding over its internal frames."""
        emb, _ = self.embed(window)
        return emb.mean(axis=0)


class EmbeddingPredictor:
    """Embedding-path inference (predict.yamn_embeddings /
    chirp_embeddings, predict.py:380-396): detect tracks -> per-track
    windows resampled to the embedding model's rate -> one embedding per
    window (on the host) -> linear-probe classifier on ``device`` ->
    per-track aggregation, mirroring
    :class:`audio_training_tpu_torch.infer.predictor.Predictor`.

    ``embedder`` is anything with ``name``, ``sample_rate`` and
    ``embed_window`` (an :class:`EmbeddingModel`); ``module`` returns
    logits (built with ``logits_only=True``) and is moved to ``device``
    and put in eval mode."""

    def __init__(
        self,
        embedder: EmbeddingModel,
        module: nn.Module,
        labels: list[str],
        cfg,
        infer_cfg: InferenceConfig | None = None,
        multi_label: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.embedder = embedder
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.labels = list(labels)
        self.cfg = cfg
        self.infer_cfg = infer_cfg or InferenceConfig()
        self.multi_label = multi_label
        self.model_name = f"embeddings-{embedder.name}"

    @torch.no_grad()
    def _probs(self, embs: np.ndarray) -> np.ndarray:
        logits = self.module(torch.as_tensor(embs, device=self.device))
        probs = (torch.sigmoid(logits) if self.multi_label
                 else torch.softmax(logits, dim=-1))
        return probs.cpu().numpy()

    def predict_windows(self, windows: np.ndarray,
                        sr: int | None = None) -> np.ndarray:
        """Classify (N, samples) windows — the strong/weak-label folder
        evaluators call this (infer/folder.py).  ``sr`` is the windows'
        sample rate (defaults to the featurizer config rate the evaluators
        extract at); each window is resampled to the embedding model's
        rate before embedding."""
        if windows.shape[0] == 0:
            return np.zeros((0, len(self.labels)), np.float32)
        sr = sr if sr is not None else self.cfg.sr
        model_sr = self.embedder.sample_rate
        embs = []
        for w in windows:
            if sr != model_sr:
                w = resample(w, sr, model_sr)
            embs.append(self.embedder.embed_window(w))
        return self._probs(np.stack(embs).astype(np.float32))

    def predict_recording(self, frames: np.ndarray, sr: int,
                          tracks: list | None = None,
                          threshold: float | np.ndarray | None = None):
        """Full pipeline: [detect tracks] -> windows -> embed -> classify ->
        aggregate.  Returns (tracks, per-track ModelResult list)."""
        threshold = (threshold if threshold is not None
                     else self.infer_cfg.threshold)
        if tracks is None:
            end = get_end(frames, sr)
            signals, _ = signal_noise(frames, sr)
            tracks = get_tracks_from_signals(signals, end)
        model_sr = self.embedder.sample_rate
        frames_rs = resample(frames, sr, model_sr) if sr != model_sr else frames
        batch = extract_track_windows(
            frames_rs, model_sr, tracks,
            segment_length=self.cfg.segment_length,
            stride=self.cfg.segment_stride,
            fmin=self.cfg.fmin, fmax=self.cfg.fmax,
        )
        if batch.windows.shape[0] == 0:
            return tracks, [None] * len(tracks)
        probs = self.predict_windows(batch.windows, sr=model_sr)
        results = aggregate_tracks(
            probs, batch.track_index, len(tracks), self.labels,
            threshold=threshold, model_name=self.model_name,
            mode=self.infer_cfg.aggregation,
        )
        for t, r in zip(tracks, results):
            if r is not None:
                t.predictions.append(r)
        return tracks, results
