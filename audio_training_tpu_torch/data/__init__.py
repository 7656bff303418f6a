"""Training data (port of ``audio_training_tpu/data``): the record format
(the TFRecord codec and the sample schema), the host loaders that stream
records into device batches, and the batch preprocess and class weighting
on the device, the vector-input streams (``embeddings``) and the offline
mixup writer (``augmented``).

The names below are resolved on first use, so that importing the record
format (``schema``, ``tfrecord``) does not import torch: the corpus tools'
worker processes read and write records with numpy alone."""

import importlib

_SOURCES = {
    "embeddings": ("EMBEDDING_DIM", "MID_FEATURES_SHAPE",
                   "SHORT_FEATURES_SHAPE", "EmbeddingStream", "FeatureStream",
                   "load_znorm", "resample_per_label"),
    "example": ("decode_example", "encode_example"),
    "pipeline": ("BatchLoader", "RecordStream", "build_training_stream",
                 "find_shards", "load_meta"),
    "preprocess": ("get_distribution", "get_weighting",
                   "make_merge_preprocess_fn", "make_preprocess_fn",
                   "weights_to_array"),
    "schema": ("DecodedSample", "SampleRecord", "decode_sample",
               "encode_sample"),
    "tfrecord": ("TFRecordWriter", "read_tfrecords", "write_tfrecords"),
}
_MODULE_OF = {name: mod for mod, names in _SOURCES.items() for name in names}
__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"),
                    name)
    globals()[name] = value
    return value
