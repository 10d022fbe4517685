"""Protobuf wire-format decoding shared by the native parsers.

Counterpart of ``analytics_zoo_tpu/common/protowire.py``, line for line:
one bounds-checked reader used by ``net/onnx_net.py`` (ONNX model import)
and ``data/tfrecord.py`` (tf.Example ingestion); the matching *encode*
helpers live in ``common/summary.py``. The wire format is decoded
directly, so neither the onnx package nor TensorFlow is needed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

WIRE_VARINT, WIRE_I64, WIRE_LEN, WIRE_I32 = 0, 1, 2, 5


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one base-128 varint at ``pos``; returns (value, next_pos)."""
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value) over one message.

    Varint fields yield ints; 64/32-bit and length-delimited fields yield
    the raw bytes. Raises ValueError on truncated or unsupported input."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == WIRE_I64:
            end = pos + 8
            if end > n:
                raise ValueError("truncated 64-bit field")
            val = buf[pos:end]
            pos = end
        elif wire == WIRE_LEN:
            ln, pos = read_varint(buf, pos)
            end = pos + ln
            if end > n:
                raise ValueError("length-delimited field overruns buffer")
            val = buf[pos:end]
            pos = end
        elif wire == WIRE_I32:
            end = pos + 4
            if end > n:
                raise ValueError("truncated 32-bit field")
            val = buf[pos:end]
            pos = end
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val
