"""Training data (port of ``audio_training_tpu/data``): the record format
(the TFRecord codec and the sample schema), the host loaders that stream
records into device batches, and the batch preprocess and class weighting
on the device.  The JAX package's ``augmented`` and ``embeddings`` modules
come with ROADMAP.md queue 1, "Host corpus tooling" and "Evaluation,
deployment and the rest of long-recording inference"."""

from audio_training_tpu_torch.data.example import decode_example, encode_example
from audio_training_tpu_torch.data.pipeline import (
    BatchLoader,
    RecordStream,
    build_training_stream,
    find_shards,
    load_meta,
)
from audio_training_tpu_torch.data.preprocess import (
    get_distribution,
    get_weighting,
    make_preprocess_fn,
    weights_to_array,
)
from audio_training_tpu_torch.data.schema import (
    DecodedSample,
    SampleRecord,
    decode_sample,
    encode_sample,
)
from audio_training_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    read_tfrecords,
    write_tfrecords,
)

__all__ = [
    "encode_example",
    "decode_example",
    "SampleRecord",
    "DecodedSample",
    "encode_sample",
    "decode_sample",
    "TFRecordWriter",
    "read_tfrecords",
    "write_tfrecords",
    "RecordStream",
    "BatchLoader",
    "build_training_stream",
    "find_shards",
    "load_meta",
    "make_preprocess_fn",
    "get_distribution",
    "get_weighting",
    "weights_to_array",
]
