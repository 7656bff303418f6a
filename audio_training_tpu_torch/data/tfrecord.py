"""TFRecord file reader/writer (GZIP), TF-free.

Wire-compatible with the reference's shards (``tf.io.TFRecordWriter(...,
TFRecordOptions(compression_type="GZIP"))``, audiowriter.py:360-488 /
``tf.data.TFRecordDataset(..., compression_type="GZIP")``,
tfdataset.py:212-214): gzip-compressed stream of crc32c-framed records.

A copy of ``audio_training_tpu/data/tfrecord.py``: records are byte-identical
with the JAX package's in both directions.
"""

from __future__ import annotations

import gzip
import zlib
from pathlib import Path
from typing import Iterable, Iterator

from audio_training_tpu_torch.data._native import frame_record, split_records


class TFRecordWriter:
    def __init__(self, path: str | Path, compression: str | None = "GZIP",
                 compresslevel: int = 6):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if compression == "GZIP":
            self._f = gzip.open(self.path, "wb", compresslevel=compresslevel)
        elif compression is None:
            self._f = open(self.path, "wb")
        else:
            raise ValueError(f"Unsupported compression {compression}")

    def write(self, record: bytes) -> None:
        self._f.write(frame_record(record))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_raw(path: Path, compression: str | None) -> bytes:
    data = path.read_bytes()
    if compression == "GZIP" or (
        compression == "auto" and data[:2] == b"\x1f\x8b"
    ):
        # wbits=47 accepts gzip (incl. multi-member via decompressobj loop)
        out = []
        while data:
            d = zlib.decompressobj(47)
            out.append(d.decompress(data))
            out.append(d.flush())
            data = d.unused_data
        return b"".join(out)
    return data


def read_tfrecords(
    path: str | Path, compression: str | None = "auto",
    verify_crc: bool = True, skip_errors: bool = False,
) -> Iterator[memoryview]:
    """Yield raw record payloads from one shard file.

    ``skip_errors=True`` mirrors the reference pipeline's
    ``tf.data.experimental.ignore_errors()`` (tfdataset.py:226): a corrupt
    shard yields the records parsed so far and stops.
    """
    path = Path(path)
    try:
        buf = _read_raw(path, compression)
        records = split_records(buf, verify_crc=verify_crc)
    except Exception:
        if skip_errors:
            return
        raise
    yield from records


def write_tfrecords(
    path: str | Path, records: Iterable[bytes], compression: str | None = "GZIP"
) -> int:
    n = 0
    with TFRecordWriter(path, compression) as w:
        for r in records:
            w.write(r)
            n += 1
    return n
