"""TF-free TensorBoard event-file writer (and reader, for tests/tools); a
copy of ``audio_training_tpu/utils/tensorboard.py:105-283``.

The reference streams per-epoch scalars, weight histograms and confusion
images to TensorBoard via ``tf.summary`` / Keras' TensorBoard callback
(``audiomodel.py:553-558`` tensorboard callback wiring,
``audiomodel.py:1262-1314`` the confusion-image callback,
``audiomodel.py:2583-2592`` log_hist_weights).  This module reproduces the
WIRE FORMAT those land in — ``events.out.tfevents.*`` files any standard
TensorBoard install can watch live — without importing TensorFlow: an
event file is a stream of crc32c-framed records (the TFRecord framing the
repo already implements TF-free, ``data/_native.frame_record``), each
record one ``tensorflow.Event`` protobuf encoded with the same hand-rolled
proto helpers as ``data/example.py``.

Proto schema subset implemented (tensorflow/core/util/event.proto +
tensorflow/core/framework/summary.proto):

    Event       { double wall_time=1; int64 step=2;
                  oneof { string file_version=3; Summary summary=5; } }
    Summary     { repeated Value value=1; }
    Value       { string tag=1; float simple_value=2;
                  Image image=4; HistogramProto histo=5; }
    Image       { int32 height=1; int32 width=2; int32 colorspace=3;
                  bytes encoded_image_string=4; }
    HistogramProto { double min=1; max=2; num=3; sum=4; sum_squares=5;
                     repeated double bucket_limit=6 [packed];
                     repeated double bucket=7 [packed]; }

TensorBoard still reads the classic ``simple_value`` scalar and
``HistogramProto`` paths (they predate the tensor-based summaries and
remain supported), so no TensorProto machinery is needed.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.data._native import frame_record, split_records
from audio_training_tpu_torch.data.example import (
    _iter_fields,
    _tag,
    _write_len_delimited,
    _write_varint,
)

_WIRE_VARINT, _WIRE_64BIT, _WIRE_LEN, _WIRE_32BIT = 0, 1, 2, 5


def _append_double(out: bytearray, field: int, value: float) -> None:
    _write_varint(out, _tag(field, _WIRE_64BIT))
    out += struct.pack("<d", float(value))


def _append_float(out: bytearray, field: int, value: float) -> None:
    _write_varint(out, _tag(field, _WIRE_32BIT))
    out += struct.pack("<f", float(value))


def _append_varint_field(out: bytearray, field: int, value: int) -> None:
    _write_varint(out, _tag(field, _WIRE_VARINT))
    _write_varint(out, int(value))


def _append_packed_doubles(out: bytearray, field: int, values) -> None:
    payload = struct.pack(f"<{len(values)}d", *[float(v) for v in values])
    _write_len_delimited(out, field, payload)


def _event(step: int, summary: bytes | None = None,
           file_version: str | None = None,
           wall_time: float | None = None) -> bytes:
    ev = bytearray()
    _append_double(ev, 1, time.time() if wall_time is None else wall_time)
    _append_varint_field(ev, 2, step)
    if file_version is not None:
        _write_len_delimited(ev, 3, file_version.encode("utf-8"))
    if summary is not None:
        _write_len_delimited(ev, 5, summary)
    return bytes(ev)


def _value(tag: str, body: bytearray) -> bytes:
    val = bytearray()
    _write_len_delimited(val, 1, tag.encode("utf-8"))
    val += body
    summary = bytearray()
    _write_len_delimited(summary, 1, bytes(val))
    return bytes(summary)


def png_dimensions(png: bytes) -> tuple[int, int]:
    """(height, width) from a PNG header (IHDR is always the first chunk:
    width/height as big-endian u32 at bytes 16..24)."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    width, height = struct.unpack(">II", png[16:24])
    return height, width


class TBEventWriter:
    """Append-per-call TensorBoard event-file writer.

    Events are framed and flushed as they are added, so ``tensorboard
    --logdir run_dir`` watches a fit live — the same observability contract
    as the reference's callback stream.  Uncompressed framing (TensorBoard
    does not read gzip event files)."""

    def __init__(self, logdir: str | Path, filename_suffix: str = ""):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "localhost"
        name = f"events.out.tfevents.{int(time.time())}.{host}"
        if filename_suffix:
            name += f".{filename_suffix}"
        self.path = self.logdir / name
        self._f = self.path.open("wb")
        # every event file leads with the version event (TB skips files
        # without it in some code paths)
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(frame_record(event))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        body = bytearray()
        _append_float(body, 2, value)
        self._write(_event(step, _value(tag, body)))

    def add_scalars(self, logs: dict, step: int) -> None:
        """One Event carrying every finite float in ``logs`` (one Value per
        tag) — the per-epoch shape the fit loop emits."""
        summary = bytearray()
        for tag in sorted(logs):
            try:
                v = float(logs[tag])
            except (TypeError, ValueError):
                continue
            body = bytearray()
            _append_float(body, 2, v)
            val = bytearray()
            _write_len_delimited(val, 1, str(tag).encode("utf-8"))
            val += body
            _write_len_delimited(summary, 1, bytes(val))
        if summary:
            self._write(_event(step, bytes(summary)))

    def add_histogram_counts(self, tag: str, counts, edges,
                             step: int, mean: float | None = None) -> None:
        """Histogram from pre-binned (counts, bin-edges) — the form the
        fit loop's weight-histogram hook produces.  ``sum``/``sum_squares``
        are reconstructed from bin centers (exact enough for the TB
        distribution display; the raw values are not retained)."""
        counts = np.asarray(counts, np.float64)
        edges = np.asarray(edges, np.float64)
        centers = (edges[:-1] + edges[1:]) / 2.0
        h = bytearray()
        _append_double(h, 1, float(edges[0]))
        _append_double(h, 2, float(edges[-1]))
        _append_double(h, 3, float(counts.sum()))
        _append_double(h, 4, float((centers * counts).sum()))
        _append_double(h, 5, float((centers**2 * counts).sum()))
        _append_packed_doubles(h, 6, edges[1:])
        _append_packed_doubles(h, 7, counts)
        body = bytearray()
        _write_len_delimited(body, 5, bytes(h))
        self._write(_event(step, _value(tag, body)))

    def add_histogram_values(self, tag: str, values, step: int,
                             bins: int = 30) -> None:
        arr = np.asarray(values, np.float64).ravel()
        if arr.size == 0:
            return
        counts, edges = np.histogram(arr, bins=bins)
        self.add_histogram_counts(tag, counts, edges, step)

    def add_image(self, tag: str, png: bytes, step: int,
                  colorspace: int = 4) -> None:
        """PNG-encoded image (colorspace 4 = RGBA, matplotlib's savefig
        default) — the per-epoch confusion image stream
        (audiomodel.py:1262-1314 encodes the figure as PNG the same way)."""
        height, width = png_dimensions(png)
        img = bytearray()
        _append_varint_field(img, 1, height)
        _append_varint_field(img, 2, width)
        _append_varint_field(img, 3, colorspace)
        _write_len_delimited(img, 4, png)
        body = bytearray()
        _write_len_delimited(body, 4, bytes(img))
        self._write(_event(step, _value(f"{tag}/image", body)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Reader (tests / tooling): parse an event file back into plain dicts.
# ---------------------------------------------------------------------------


def _parse_histo(buf) -> dict:
    out: dict = {}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    for field, wire, payload in _iter_fields(buf):
        if field in names:
            out[names[field]] = struct.unpack("<d", payload)[0]
        elif field in (6, 7):
            key = "bucket_limit" if field == 6 else "bucket"
            vals = out.setdefault(key, [])
            if wire == _WIRE_LEN:  # packed
                vals.extend(np.frombuffer(payload, "<f8").tolist())
            else:
                vals.append(struct.unpack("<d", payload)[0])
    return out


def _parse_image(buf) -> dict:
    out: dict = {}
    names = {1: "height", 2: "width", 3: "colorspace"}
    for field, wire, payload in _iter_fields(buf):
        if field in names:
            out[names[field]] = struct.unpack("<q", payload)[0]
        elif field == 4:
            out["png"] = bytes(payload)
    return out


def _parse_value(buf) -> tuple[str, str, object]:
    tag, kind, value = "", "", None
    for field, wire, payload in _iter_fields(buf):
        if field == 1:
            tag = bytes(payload).decode("utf-8")
        elif field == 2:
            kind, value = "scalar", struct.unpack("<f", payload)[0]
        elif field == 4:
            kind, value = "image", _parse_image(payload)
        elif field == 5:
            kind, value = "histo", _parse_histo(payload)
    return tag, kind, value


def read_events(path: str | Path) -> list[dict]:
    """Parse one event file: a list of
    ``{"wall_time", "step", ("file_version" | "scalars" | "histos" |
    "images")}`` dicts.  Used by the round-trip tests and as a standalone
    no-TF event inspector."""
    events = []
    for record in split_records(Path(path).read_bytes()):
        ev: dict = {"step": 0}
        for field, wire, payload in _iter_fields(memoryview(record)):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", payload)[0]
            elif field == 2:
                ev["step"] = struct.unpack("<q", payload)[0]
            elif field == 3:
                ev["file_version"] = bytes(payload).decode("utf-8")
            elif field == 5:
                for f2, w2, val_buf in _iter_fields(payload):
                    if f2 != 1:
                        continue
                    tag, kind, value = _parse_value(val_buf)
                    if kind == "scalar":
                        ev.setdefault("scalars", {})[tag] = value
                    elif kind == "histo":
                        ev.setdefault("histos", {})[tag] = value
                    elif kind == "image":
                        ev.setdefault("images", {})[tag] = value
        events.append(ev)
    return events
