"""TFRecord / tf.Example reader and writer — no TensorFlow dependency.

Counterpart of ``analytics_zoo_tpu/data/tfrecord.py`` (ref
``pyzoo/zoo/tfpark/tf_dataset.py:915`` TFBytesDataset and the
TFRecordDataset examples): the wire format is parsed directly (the same
hand-rolled protobuf as ``net/onnx_net.py`` and the TF-events writer in
``common/summary.py``) into ``XShards`` of feature dicts, ready for a
``ShardedDataset`` and a fit on the card. For the same records the two
packages write the same bytes, and each reads the other's files.

Wire formats:
- TFRecord framing: ``uint64le length | masked-crc32c(length) | payload |
  masked-crc32c(payload)`` (common/summary.py's helpers). The header's
  CRC is checked before its length is trusted; truncated or corrupt input
  raises ``IOError``.
- ``tf.Example``: Example{features=1} -> Features{map<string,Feature>=1}
  -> Feature{bytes_list=1 | float_list=2 | int64_list=3}, each a repeated
  ``value`` field 1 (floats/ints packed or unpacked).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.common.protowire import iter_fields as _fields
from analytics_zoo_tpu_torch.common.protowire import \
    read_varint as _read_varint
from analytics_zoo_tpu_torch.common.summary import (_masked_crc,
                                                    _pb_string, _record,
                                                    _tag, _varint)
from analytics_zoo_tpu_torch.data.shard import HostXShards

__all__ = ["write_tfrecords", "read_tfrecords", "read_tfrecords_as_shards",
           "parse_example", "encode_example"]


# ---------------- encoding ----------------

def _float_list(values: np.ndarray) -> bytes:
    packed = np.ascontiguousarray(values.reshape(-1), "<f4").tobytes()
    return _tag(1, 2) + _varint(len(packed)) + packed


def _int64_list(values: np.ndarray) -> bytes:
    body = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                    for v in values.reshape(-1).tolist())
    return _tag(1, 2) + _varint(len(body)) + body


def _bytes_list(values: Sequence[bytes]) -> bytes:
    return b"".join(_pb_string(1, v) for v in values)


def encode_example(record: Dict[str, Union[np.ndarray, bytes, str,
                                           Sequence]]) -> bytes:
    """Encode one feature dict as a serialized ``tf.Example``.

    float arrays → float_list, integer arrays → int64_list,
    bytes/str (or lists of them) → bytes_list."""
    feats = b""
    for key in sorted(record):
        val = record[key]
        if isinstance(val, (bytes, str)):
            val = [val]
        if isinstance(val, (list, tuple)) and val and \
                isinstance(val[0], (bytes, str)):
            payload = _bytes_list([v.encode() if isinstance(v, str) else v
                                   for v in val])
            feature = _pb_string(1, payload)
        else:
            arr = np.asarray(val)
            if np.issubdtype(arr.dtype, np.floating):
                feature = _pb_string(2, _float_list(arr.astype(np.float32)))
            elif np.issubdtype(arr.dtype, np.integer) or \
                    arr.dtype == np.bool_:
                feature = _pb_string(3, _int64_list(arr.astype(np.int64)))
            else:
                raise TypeError(f"unsupported feature dtype for {key!r}: "
                                f"{arr.dtype}")
        entry = _pb_string(1, key.encode()) + _pb_string(2, feature)
        feats += _pb_string(1, entry)          # map entry in Features
    return _pb_string(1, feats)                # Example.features


def write_tfrecords(path: str, records: Iterable[Dict]) -> int:
    """Write records (feature dicts) to one TFRecord file; returns count."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "wb") as fh:
        for rec in records:
            fh.write(_record(encode_example(rec)))
            n += 1
    return n


# ---------------- decoding (wire parser: common/protowire.py) ----------------

def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_feature(buf: bytes):
    for field, wire, val in _fields(buf):
        if field == 1:                      # BytesList
            return [v for f, _, v in _fields(val) if f == 1]
        if field == 2:                      # FloatList
            floats: List[float] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:                  # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:                       # unpacked 32-bit
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:                      # Int64List
            ints: List[int] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:                  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_signed64(x))
                else:
                    ints.append(_signed64(v))
            return np.asarray(ints, np.int64)
    return None


def parse_example(buf: bytes) -> Dict[str, Union[np.ndarray, List[bytes]]]:
    """Parse one serialized tf.Example into a feature dict."""
    out: Dict = {}
    for field, _, features in _fields(buf):
        if field != 1:
            continue
        for f, _, entry in _fields(features):
            if f != 1:
                continue
            key = value = None
            for ef, _, ev in _fields(entry):
                if ef == 1:
                    key = ev.decode()
                elif ef == 2:
                    value = _decode_feature(ev)
            if key is not None:
                out[key] = value
    return out


def _iter_records(path: str, verify_crc: bool = True):
    with open(path, "rb") as fh:
        while True:
            header = fh.read(8)
            if not header:
                return                      # clean EOF
            if len(header) < 8:
                raise IOError(f"truncated TFRecord in {path}")
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = fh.read(4)
            if len(hcrc_raw) < 4:
                raise IOError(f"truncated TFRecord in {path}")
            # verify the header BEFORE trusting `length` for the payload
            # read — a corrupt length would otherwise drive a huge read
            if verify_crc and \
                    struct.unpack("<I", hcrc_raw)[0] != _masked_crc(header):
                raise IOError(f"corrupt TFRecord header in {path}")
            data = fh.read(length)
            dcrc_raw = fh.read(4)
            if len(data) < length or len(dcrc_raw) < 4:
                raise IOError(f"truncated TFRecord in {path}")
            if verify_crc and \
                    struct.unpack("<I", dcrc_raw)[0] != _masked_crc(data):
                raise IOError(f"corrupt TFRecord payload in {path}")
            yield data


def read_tfrecords(paths: Union[str, Sequence[str]],
                   verify_crc: bool = True) -> List[Dict]:
    """Read TFRecord file(s) of tf.Examples into a list of feature dicts.
    ``paths`` may be a file, a directory (all ``*.tfrecord*`` inside), or a
    list of files."""
    if isinstance(paths, str):
        if os.path.isdir(paths):
            paths = sorted(
                os.path.join(paths, f) for f in os.listdir(paths)
                if ".tfrecord" in f or f.endswith(".tfr"))
        else:
            paths = [paths]
    out = []
    for p in paths:
        for rec in _iter_records(p, verify_crc):
            out.append(parse_example(rec))
    return out


def read_tfrecords_as_shards(paths: Union[str, Sequence[str]],
                             num_shards: Optional[int] = None
                             ) -> HostXShards:
    """Read tf.Examples into ``XShards`` (lists of feature dicts), ready
    for ``transform_shard`` / ``ShardedDataset`` (the reference's
    TFBytesDataset → FeatureSet hop collapses into this one step)."""
    return HostXShards.from_records(read_tfrecords(paths), num_shards)
