"""ctypes binding for the native TFRecord codec (a copy of
``audio_training_tpu/data/_native.py``), with a pure-Python fallback
(crc32c table in numpy) when no compiler exists.

The library is built from ``native/tfrecord_codec.cc`` by its Makefile at
first use, into the repository's git-ignored ``build/native/`` (never into
the package).  Each build writes a fresh directory and moves the library
into place, so processes that build at once never load a half-written
file.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = NATIVE_DIR.parent.parent / "build" / "native"
LIB_PATH = BUILD_DIR / "libtfrecord_codec.so"

_lib = None
_tried = False


def _build() -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            subprocess.run(["make", "-C", str(NATIVE_DIR), f"OUT={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(Path(tmp) / LIB_PATH.name, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native codec build failed: %s", e)
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not LIB_PATH.exists() and not _build():
        return None
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.att_crc32c.restype = ctypes.c_uint32
    lib.att_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.att_masked_crc.restype = ctypes.c_uint32
    lib.att_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.att_split_records.restype = ctypes.c_int64
    lib.att_split_records.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.att_frame_record.restype = ctypes.c_uint64
    lib.att_frame_record.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Pure-python fallback crc32c
# ---------------------------------------------------------------------------

_PY_TABLE = None


def _py_table() -> np.ndarray:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _PY_TABLE = table
    return _PY_TABLE


def _py_crc32c(data: bytes) -> int:
    table = _py_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = get_lib()
    if lib is not None:
        return lib.att_crc32c(data, len(data))
    return _py_crc32c(data)


def masked_crc(data: bytes) -> int:
    lib = get_lib()
    if lib is not None:
        return lib.att_masked_crc(data, len(data))
    crc = _py_crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def split_records(buf: bytes, verify_crc: bool = True) -> list[memoryview]:
    """Split a decompressed TFRecord stream into payload views."""
    lib = get_lib()
    mv = memoryview(buf)
    if lib is not None:
        count = lib.att_split_records(buf, len(buf), None, None, 0, 0)
        if count < 0:
            raise ValueError(f"corrupt tfrecord stream (error {count})")
        offsets = (ctypes.c_uint64 * count)()
        lengths = (ctypes.c_uint64 * count)()
        got = lib.att_split_records(
            buf, len(buf), offsets, lengths, count, 1 if verify_crc else 0
        )
        if got < 0:
            raise ValueError(f"corrupt tfrecord stream (crc error {got})")
        return [mv[offsets[i] : offsets[i] + lengths[i]] for i in range(got)]
    # fallback: python framing (crc verification optional and slow)
    out = []
    pos = 0
    n = len(buf)
    while pos < n:
        if pos + 12 > n:
            raise ValueError("corrupt tfrecord stream (truncated header)")
        (length,) = struct.unpack_from("<Q", buf, pos)
        data_off = pos + 12
        if data_off + length + 4 > n:
            raise ValueError("corrupt tfrecord stream (truncated payload)")
        if verify_crc:
            (expect,) = struct.unpack_from("<I", buf, data_off + length)
            if masked_crc(bytes(mv[data_off : data_off + length])) != expect:
                raise ValueError("corrupt tfrecord stream (crc mismatch)")
        out.append(mv[data_off : data_off + length])
        pos = data_off + length + 4
    return out


def frame_record(data: bytes) -> bytes:
    """Wrap one serialized Example in TFRecord framing."""
    lib = get_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(len(data) + 16)
        n = lib.att_frame_record(data, len(data), out)
        return out.raw[:n]
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc(header))
        + data
        + struct.pack("<I", masked_crc(data))
    )
