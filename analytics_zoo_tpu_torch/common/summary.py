"""TensorBoard event writer with no TensorFlow dependency.

Counterpart of ``analytics_zoo_tpu/common/summary.py`` (ref the JVM's own
writer, ``zoo/.../tensorboard/FileWriter.scala``, ``EventWriter``,
``RecordWriter``): training summaries ("Loss", "Throughput",
"LearningRate", the validation metrics; ref Topology.scala:208-240) are
scalar events, hand-encoded protobuf in TFRecord framing (a length, its
masked CRC32C, the payload, its masked CRC32C), written to
``events.out.tfevents.<seconds>.<host>``.

The encoding is the JAX package's byte for byte (for a given wall time,
step, tag and value), so each package's ``read_scalars`` reads the
other's files, and TensorBoard reads both.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

# ---------------- CRC32C (Castagnoli) ----------------


def _make_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------- minimal protobuf encoding ----------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int, tag: Optional[str] = None,
           value: Optional[float] = None,
           file_version: Optional[str] = None) -> bytes:
    """An ``Event``: wall_time (field 1, double), step (2, int64),
    file_version (3, string) or summary (5): ``Summary.value`` (1) holding
    tag (1, string) and simple_value (2, float)."""
    out = _pb_double(1, time.time())  # zoolint: disable=wallclock-hotpath (event timestamp)
    out += _pb_int64(2, step)
    if file_version is not None:
        out += _pb_string(3, file_version.encode())
    if tag is not None:
        value_msg = _pb_string(1, tag.encode()) + _pb_float(2, value)
        out += _pb_string(5, _pb_string(1, value_msg))
    return out


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


#: buffered-writer thresholds: whichever trips first forces a flush
FLUSH_BYTES = 64 * 1024
FLUSH_EVERY = 128


class SummaryWriter:
    """Append-only scalar event writer (ref FileWriter.scala /
    EventWriter).

    Events accumulate in memory and reach the file in one write when
    ``flush_bytes`` or ``flush_every`` (events) is reached, on ``flush()``
    or on ``close()``. ``close()`` is idempotent and final: later
    ``add_scalar``/``flush`` calls are dropped. ``get_scalar`` reads the
    values back from memory."""

    def __init__(self, log_dir: str, flush_bytes: int = FLUSH_BYTES,
                 flush_every: int = FLUSH_EVERY):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        fname = (f"events.out.tfevents.{int(time.time())}."  # zoolint: disable=wallclock-hotpath
                 f"{socket.gethostname()}")
        self._path = os.path.join(log_dir, fname)
        self._lock = threading.RLock()
        self._flush_bytes = int(flush_bytes)
        self._flush_every = int(flush_every)
        self._buf = bytearray()
        self._buf_events = 0
        self._closed = False
        self._fh = open(self._path, "ab")
        self._fh.write(_record(_event(0, file_version="brain.Event:2")))
        self._fh.flush()
        self._scalars: Dict[str, List[Tuple[int, float]]] = {}

    def add_scalar(self, tag: str, value: float, step: int):
        with self._lock:
            if self._closed:
                return
            self._buf += _record(_event(step, tag, float(value)))
            self._buf_events += 1
            self._scalars.setdefault(tag, []).append((step, float(value)))
            if (len(self._buf) >= self._flush_bytes
                    or self._buf_events >= self._flush_every):
                self._flush_locked()

    def _flush_locked(self):
        if self._buf:
            self._fh.write(bytes(self._buf))
            self._buf.clear()
            self._buf_events = 0
        self._fh.flush()

    def flush(self):
        with self._lock:
            if not self._closed:
                self._flush_locked()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._fh.close()
            self._closed = True

    def get_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """``[(step, value)]`` of ``tag``, in the order written."""
        return list(self._scalars.get(tag, []))


# ---------------- reading ----------------

def _read_varint(buf: bytes, p: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[p]
        v |= (b & 0x7F) << shift
        p += 1
        if not b & 0x80:
            return v, p
        shift += 7


#: the byte length of protobuf's fixed-width wire types (64- and 32-bit)
_FIXED = {1: 8, 5: 4}


def _fields(buf: bytes):
    """Yield ``(field, wire, value)``: an int for varints, the bytes of a
    length-delimited field, the raw 4 or 8 bytes of a fixed one."""
    p = 0
    while p < len(buf):
        key, p = _read_varint(buf, p)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, p = _read_varint(buf, p)
        elif wire == 2:
            n, p = _read_varint(buf, p)
            v, p = buf[p:p + n], p + n
        elif wire in _FIXED:
            v, p = buf[p:p + _FIXED[wire]], p + _FIXED[wire]
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _parse_value(buf: bytes) -> Tuple[Optional[str], Optional[float]]:
    tag = value = None
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            tag = v.decode("utf-8", "replace")
        elif field == 2 and wire == 5:
            (value,) = struct.unpack("<f", v)
    return tag, value


def _parse_event(buf: bytes):
    step, tag, value = 0, None, None
    for field, wire, v in _fields(buf):
        if field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:
            for sfield, swire, sv in _fields(v):
                if sfield == 1 and swire == 2:
                    tag, value = _parse_value(sv)
    return step, tag, value


def read_scalars(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """An events file as ``{tag: [(step, value)]}`` (the scalar events;
    the file-version record carries no tag)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 12                          # the length and its CRC
        payload = data[pos:pos + length]
        pos += length + 4                  # the payload and its CRC
        step, tag, value = _parse_event(payload)
        if tag is not None:
            out.setdefault(tag, []).append((step, value))
    return out
