"""Record schema — feature-key parity with the reference writer
(audiowriter.create_tf_example, audiowriter.py:67-174).

A record carries the raw 3 s waveform (144 000 f32), optionally the full
magnitude STFT (2049*513 f32, tfdataset.py:1028-1034), location, rec/track
ids, per-sample signal stats, and text/eBird tag strings.  The decoder is
lazy: training only materializes ``audio/raw`` + labels, skipping the 4 MB
spectrogram payload entirely (the reference parses it then drops it).

A copy of ``audio_training_tpu/data/schema.py``: records are byte-identical
with the JAX package's in both directions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from audio_training_tpu_torch.data import example as ex

KEY_RAW = "audio/raw"
KEY_SPECTOGRAM = "audio/spectogram"  # reference spelling preserved
KEY_EMBEDDING = "embedding"

# hand-crafted feature-tensor contract (audiomodel.py:685-686,
# tfdataset.py:1041-1045) — single source of truth for writer, streams
# and the cnn-features/merge model constructors
SHORT_FEATURES_SHAPE = (68, 60)
MID_FEATURES_SHAPE = (136, 3)
KEY_LOGITS = "logits"


@dataclass
class SampleRecord:
    """One 3 s training example (mirrors AudioSample + SpectrogramData)."""

    raw: np.ndarray  # (samples,) float32
    tags: list[str]  # eBird-id tags ("audio/class/ebird", space separated)
    text_tags: list[str] = field(default_factory=list)
    rec_id: str = ""
    track_ids: list[str] = field(default_factory=list)
    sr: int = 48000
    lat: float = 0.0
    lng: float = 0.0
    min_freq: float = -1.0
    max_freq: float = -1.0
    length: float = 3.0
    raw_length: float = 3.0
    start_s: float = 0.0
    signal_percent: float = 0.0
    low_sample: int = 0
    spectogram: Optional[np.ndarray] = None
    short_features: Optional[np.ndarray] = None
    mid_features: Optional[np.ndarray] = None
    buttered: Optional[np.ndarray] = None
    mixed_label: Optional[str] = None
    embed_predictions: Optional[str] = None
    embeddings: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None


def encode_sample(s: SampleRecord) -> bytes:
    """Serialize to the reference feature dict (audiowriter.py:100-173)."""
    feats: dict[str, bytes] = {
        "audio/lat": ex.float_feature(s.lat),
        "audio/lng": ex.float_feature(s.lng),
        "audio/rec_id": ex.bytes_feature(str(s.rec_id).encode("utf-8")),
        "audio/track_id": ex.bytes_feature(
            " ".join(map(str, s.track_ids)).encode("utf-8")
        ),
        "audio/sample_rate": ex.int64_feature(s.sr),
        "audio/min_freq": ex.float_feature(
            -1 if s.min_freq is None else s.min_freq
        ),
        "audio/max_freq": ex.float_feature(
            -1 if s.max_freq is None else s.max_freq
        ),
        "audio/length": ex.float_feature(s.length),
        "audio/signal_percent": ex.float_feature(s.signal_percent or 0),
        "audio/low_sample": ex.int64_feature(int(s.low_sample)),
        "audio/raw_length": ex.float_feature(s.raw_length),
        "audio/start_s": ex.float_feature(s.start_s),
        "audio/class/text": ex.bytes_feature(
            "\n".join(s.text_tags).encode("utf-8")
        ),
        "audio/class/ebird": ex.bytes_feature(
            "\n".join(s.tags).encode("utf-8")
        ),
        KEY_RAW: ex.float_list_feature(np.float32(np.ravel(s.raw))),
    }
    if s.spectogram is not None:
        feats[KEY_SPECTOGRAM] = ex.float_list_feature(
            np.float32(np.ravel(s.spectogram))
        )
    if s.short_features is not None:
        feats["audio/short_f"] = ex.float_list_feature(
            np.float32(np.ravel(s.short_features))
        )
    if s.mid_features is not None:
        feats["audio/mid_f"] = ex.float_list_feature(
            np.float32(np.ravel(s.mid_features))
        )
    if s.buttered is not None:
        feats["audio/buttered"] = ex.float_list_feature(
            np.float32(np.ravel(s.buttered))
        )
    if s.mixed_label is not None:
        feats["audio/class/mixed_label"] = ex.bytes_feature(
            s.mixed_label.encode("utf-8")
        )
    if s.embed_predictions is not None:
        feats["audio/embed_predictions"] = ex.bytes_feature(
            s.embed_predictions.encode("utf-8")
        )
    if s.embeddings is not None:
        feats[KEY_EMBEDDING] = ex.float_list_feature(
            np.float32(np.ravel(s.embeddings))
        )
        feats[KEY_LOGITS] = ex.float_list_feature(
            np.float32(np.ravel(s.logits))
        )
        feats["embedding_shape"] = ex.int64_list_feature(s.embeddings.shape)
    return ex.encode_example(feats)


def _split_tags(raw: bytes) -> list[str]:
    """Tags are newline separated by our writer; the reference joins with
    '\\n' too (audiodataset.py tags_s).  Tolerate space/comma variants."""
    text = raw.decode("utf-8").strip()
    if not text:
        return []
    for sep in ("\n", ","):
        if sep in text:
            return [t.strip() for t in text.split(sep) if t.strip()]
    return [text]


@dataclass
class DecodedSample:
    raw: np.ndarray
    tags: list[str]
    text_tags: list[str]
    rec_id: str
    track_ids: list[str]
    lat: float
    lng: float
    signal_percent: float
    low_sample: int
    start_s: float
    min_freq: float
    max_freq: float
    spectogram: Optional[np.ndarray] = None
    embeddings: Optional[np.ndarray] = None
    short_features: Optional[np.ndarray] = None
    mid_features: Optional[np.ndarray] = None
    buttered: Optional[np.ndarray] = None  # band-passed raw (filter_freq)


def decode_sample(
    record: bytes | memoryview,
    want_raw: bool = True,
    want_spectogram: bool = False,
    want_embeddings: bool = False,
    want_features: bool = False,
    want_buttered: bool = False,
) -> DecodedSample:
    f = ex.decode_example(record)

    def get_f(key, default=0.0):
        return f[key].scalar_float() if key in f else default

    def get_b(key):
        return f[key].scalar_bytes() if key in f else b""

    raw = f[KEY_RAW].float_array() if want_raw and KEY_RAW in f else np.empty(0, np.float32)
    spec = None
    if want_spectogram and KEY_SPECTOGRAM in f:
        spec = f[KEY_SPECTOGRAM].float_array()
    emb = None
    if want_embeddings and KEY_EMBEDDING in f:
        emb = f[KEY_EMBEDDING].float_array()
        if "embedding_shape" in f:
            emb = emb.reshape(f["embedding_shape"].int64_list())
    short_f = mid_f = None
    if want_features:
        if "audio/short_f" in f:
            short_f = f["audio/short_f"].float_array().reshape(68, 60)
        if "audio/mid_f" in f:
            mid_f = f["audio/mid_f"].float_array().reshape(136, 3)
    buttered = None
    if want_buttered and "audio/buttered" in f:
        buttered = f["audio/buttered"].float_array()
    return DecodedSample(
        raw=raw,
        tags=_split_tags(get_b("audio/class/ebird")),
        text_tags=_split_tags(get_b("audio/class/text")),
        rec_id=get_b("audio/rec_id").decode("utf-8"),
        track_ids=get_b("audio/track_id").decode("utf-8").split(),
        lat=get_f("audio/lat"),
        lng=get_f("audio/lng"),
        signal_percent=get_f("audio/signal_percent"),
        low_sample=f["audio/low_sample"].scalar_int() if "audio/low_sample" in f else 0,
        start_s=get_f("audio/start_s"),
        min_freq=get_f("audio/min_freq", -1),
        max_freq=get_f("audio/max_freq", -1),
        spectogram=spec,
        embeddings=emb,
        short_features=short_f,
        mid_features=mid_f,
        buttered=buttered,
    )
