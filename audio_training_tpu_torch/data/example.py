"""Minimal tf.train.Example wire-format codec — no TensorFlow dependency.

Replaces the reference's ``tfrecord_util.py`` feature constructors and TF's
proto runtime with a hand-rolled protobuf codec for exactly the three message
shapes TFRecord training data uses::

    Example       { Features features = 1; }
    Features      { map<string, Feature> feature = 1; }
    Feature       { oneof { BytesList b = 1; FloatList f = 2; Int64List i = 3 } }
    BytesList     { repeated bytes value = 1; }
    FloatList     { repeated float value = 1 [packed]; }
    Int64List     { repeated int64 value = 1 [packed]; }

Packed FloatList payloads are contiguous little-endian float32, so decoding a
144 000-sample waveform is a single ``np.frombuffer`` — no per-element work.

A copy of ``audio_training_tpu/data/example.py``: records are byte-identical
with the JAX package's in both directions.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, _WIRE_LEN))
    _write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def bytes_feature(value: bytes) -> bytes:
    """Feature{bytes_list{value:[value]}} (tfrecord_util.py bytes_feature)."""
    inner = bytearray()
    _write_len_delimited(inner, 1, value)
    out = bytearray()
    _write_len_delimited(out, 1, bytes(inner))
    return bytes(out)


def bytes_list_feature(values: list[bytes]) -> bytes:
    inner = bytearray()
    for v in values:
        _write_len_delimited(inner, 1, v)
    out = bytearray()
    _write_len_delimited(out, 1, bytes(inner))
    return bytes(out)


def float_feature(value: float) -> bytes:
    return float_list_feature(np.asarray([value], np.float32))


def float_list_feature(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, dtype="<f4")
    inner = bytearray()
    _write_len_delimited(inner, 1, values.tobytes())
    out = bytearray()
    _write_len_delimited(out, 2, bytes(inner))
    return bytes(out)


def int64_feature(value: int) -> bytes:
    return int64_list_feature([value])


def int64_list_feature(values) -> bytes:
    payload = bytearray()
    for v in values:
        # protobuf int64 negative values use 10-byte two's complement varint
        _write_varint(payload, int(v) & 0xFFFFFFFFFFFFFFFF)
    inner = bytearray()
    _write_len_delimited(inner, 1, bytes(payload))
    out = bytearray()
    _write_len_delimited(out, 3, bytes(inner))
    return bytes(out)


def encode_example(features: dict[str, bytes]) -> bytes:
    """Serialize {name -> encoded Feature} into an Example proto."""
    feats = bytearray()
    for name, feature_bytes in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, feature_bytes)
        _write_len_delimited(feats, 1, bytes(entry))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(feats))
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, memoryview]]:
    """Yield (field_number, wire_type, payload_view) over a message buffer.
    For varint fields the payload view is the varint's value packed as 8-byte
    little-endian (so callers get a uniform memoryview interface)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_LEN:
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
            if value >= 2**63:  # two's-complement int64
                value -= 2**64
            yield field, wire, memoryview(struct.pack("<q", value))
        elif wire == _WIRE_64BIT:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_32BIT:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported wire type {wire}")


class Feature:
    """Lazy view over one Feature message."""

    __slots__ = ("kind", "_payload")

    def __init__(self, kind: int, payload: memoryview):
        self.kind = kind  # 1=bytes, 2=float, 3=int64
        self._payload = payload

    def bytes_list(self) -> list[bytes]:
        return [bytes(v) for f, w, v in _iter_fields(self._payload) if f == 1]

    def float_array(self) -> np.ndarray:
        chunks = [v for f, w, v in _iter_fields(self._payload) if f == 1]
        if len(chunks) == 1:
            return np.frombuffer(chunks[0], dtype="<f4")
        if not chunks:
            return np.empty(0, np.float32)
        return np.concatenate([np.frombuffer(c, dtype="<f4") for c in chunks])

    def int64_list(self) -> list[int]:
        out: list[int] = []
        for f, w, v in _iter_fields(self._payload):
            if f != 1:
                continue
            if w == _WIRE_LEN:  # packed
                pos = 0
                mv = v
                while pos < len(mv):
                    val, pos = _read_varint(mv, pos)
                    if val >= 2**63:
                        val -= 2**64
                    out.append(val)
            else:
                out.append(struct.unpack("<q", v)[0])
        return out

    def scalar_float(self) -> float:
        arr = self.float_array()
        return float(arr[0]) if arr.size else 0.0

    def scalar_int(self) -> int:
        vals = self.int64_list()
        return vals[0] if vals else 0

    def scalar_bytes(self) -> bytes:
        vals = self.bytes_list()
        return vals[0] if vals else b""


def decode_example(data: bytes | memoryview) -> dict[str, Feature]:
    """Parse an Example proto into {feature name -> Feature view}."""
    buf = memoryview(data)
    out: dict[str, Feature] = {}
    for f, w, features_buf in _iter_fields(buf):
        if f != 1:
            continue
        for f2, w2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            name = None
            feat = None
            for f3, w3, v in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v).decode("utf-8")
                elif f3 == 2:
                    for f4, w4, payload in _iter_fields(v):
                        feat = Feature(f4, payload)
            if name is not None and feat is not None:
                out[name] = feat
    return out
