"""Serving wire format — how tensors travel through the data plane.

The port's own copy of ``analytics_zoo_tpu/serving/schema.py``. A record
is one JSON object — ``{"uri", "inputs": {name: tensor}}`` — where each
tensor carries dtype/shape plus b64 raw bytes (C-order), the whole record
b64-wrapped for the line protocol. Records and results are byte-compatible
with the JAX package's. Optional record encryption plugs in as an
(encrypt, decrypt) byte-callable pair.

A record's side channel (``"trace"``) carries the client's stamp: the
enqueue time on both clocks (``t_pc`` from ``perf_counter``, ``t_wall``
from ``time.time``), the sampling flag, the priority lane (``"p"``), the
relative ``deadline_ms`` (``"d"``) and a generate request (``"g"``). A
deadline that lapses before the engine serves the record gets a typed
expired result, which decodes into :class:`DeadlineExpiredError`.

An image record carries raw encoded image bytes (``{"image": b64}``),
which decode into :class:`ImageBytes`; the engine decodes the image and
runs its preprocessing chain.

The reference client's Arrow records (``{"uri", "data": b64(Arrow
stream)}``: ``encode_record_arrow`` / ``decode_arrow_inputs``, JAX's
code) decode with ``pyarrow``, imported where a record is read or
written. On a host without it an Arrow record decodes into an
:class:`UnsupportedInput` marker naming the package, and the engine
answers the record with that typed error instead of dropping it.
Encrypted records (``record_encrypted``) pass the whole body through
the cipher pair of ``common/encryption.make_cipher``.
"""

from __future__ import annotations

import base64
import json
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

Cipher = Optional[Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]]

# uris become fields of the space/newline-delimited broker protocol: a
# permissive uri would corrupt the framing (or inject commands), so the
# charset is locked down at the schema boundary.
_URI_RE = re.compile(r"^[A-Za-z0-9._:-]{1,256}$")


class ServingError(RuntimeError):
    """An error result stored in place of a prediction."""


class DeadlineExpiredError(ServingError):
    """The record's ``deadline_ms`` elapsed before the engine could serve
    it — the engine stored an explicit expired result (never a silent
    drop), and decoding that result raises this."""


#: priority lanes, highest first. The lane name doubles as the broker's
#: lane tag and the ``priority`` label on serving metrics.
PRIORITIES = ("interactive", "default", "batch")
DEFAULT_PRIORITY = "default"


def validate_priority(priority: Optional[str]) -> str:
    if priority is None:
        return DEFAULT_PRIORITY
    if priority not in PRIORITIES:
        raise ValueError(
            f"bad priority {priority!r}: one of {PRIORITIES}")
    return priority


#: generation feedback modes a generate record may request (mirrors
#: inference/generation.MODES, kept here so the wire schema needs no torch)
GENERATE_MODES = ("raw", "greedy", "sample")


def validate_generate(generate) -> Optional[Dict[str, Any]]:
    """Normalize a client ``generate`` request into the compact wire form
    carried on the record's side channel (the ``"g"`` key): ``{"n":
    steps[, "m": mode, "t": temperature, "s": seed]}``, defaults (greedy,
    temperature 1.0, no seed) omitted. Accepts the long keys
    ``max_new_tokens``/``mode``/``temperature``/``seed`` or the wire keys;
    ``None`` passes through (not a generate record)."""
    if generate is None:
        return None
    if not isinstance(generate, dict):
        raise ValueError("generate must be a dict of decode options")
    g = dict(generate)
    n = g.pop("max_new_tokens", g.pop("n", 16))
    mode = g.pop("mode", g.pop("m", "greedy"))
    temperature = g.pop("temperature", g.pop("t", 1.0))
    seed = g.pop("seed", g.pop("s", None))
    if g:
        raise ValueError(f"unknown generate keys: {sorted(g)}")
    n = int(n)
    if n < 1:
        raise ValueError(f"generate max_new_tokens must be >= 1, got {n}")
    if mode not in GENERATE_MODES:
        raise ValueError(
            f"bad generate mode {mode!r}: one of {GENERATE_MODES}")
    out: Dict[str, Any] = {"n": n}
    if mode != "greedy":
        out["m"] = str(mode)
    if float(temperature) != 1.0:
        out["t"] = float(temperature)
    if seed is not None:
        out["s"] = int(seed)
    return out


class ImageBytes:
    """A raw encoded image (JPEG, PNG) riding a record, decoded and run
    through the engine's preprocessing chain: the reference's serving
    flow (client.py:144 enqueues b64 image bytes; the JVM decodes and
    preprocesses in PreProcessing.scala:67-90)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = bytes(data)


class UnsupportedInput:
    """An input this host cannot decode: ``kind`` is ``"arrow"`` (the
    reference client's Arrow record) and ``package`` the one it needs and
    lacks (``"pyarrow"``)."""

    __slots__ = ("kind", "package")

    def __init__(self, kind: str, package: str):
        self.kind = kind
        self.package = package

    def __repr__(self) -> str:
        return f"UnsupportedInput({self.kind!r}, {self.package!r})"


def validate_uri(uri: str) -> str:
    if not _URI_RE.match(uri or ""):
        raise ValueError(
            f"bad uri {uri!r}: use 1-256 chars of [A-Za-z0-9._:-]")
    return uri


def encode_tensor(arr) -> dict:
    if isinstance(arr, ImageBytes):
        return {"image": base64.b64encode(arr.data).decode()}
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode()}


def decode_tensor(obj: dict):
    if "image" in obj:
        return ImageBytes(base64.b64decode(obj["image"]))
    raw = base64.b64decode(obj["data"])
    return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]).copy()


def _wrap(obj: dict, cipher: Cipher) -> str:
    body = json.dumps(obj).encode()
    if cipher is not None:
        body = cipher[0](body)
    return base64.b64encode(body).decode()


def _unwrap(payload_b64: str, cipher: Cipher) -> dict:
    body = base64.b64decode(payload_b64)
    if cipher is not None:
        body = cipher[1](body)
    return json.loads(body)


def encode_record(uri: str, inputs: Dict[str, np.ndarray],
                  cipher: Cipher = None,
                  trace: Optional[Dict[str, Any]] = None) -> str:
    """``trace``: the client's side-channel stamp (``{"id", "t_pc",
    "t_wall", "s"[, "p", "d", "g"]}``), written as the JAX client writes
    it; ``"g"`` is a generate request in wire form
    (``validate_generate``)."""
    obj: Dict[str, Any] = {"uri": uri,
                           "inputs": {k: encode_tensor(
                               v if isinstance(v, ImageBytes)
                               else np.asarray(v))
                               for k, v in inputs.items()}}
    if trace:
        obj["trace"] = trace
    return _wrap(obj, cipher)


def _has_pyarrow() -> bool:
    """Whether this host can read an Arrow record (the answer to one
    that it cannot read is a typed error naming pyarrow)."""
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return False
    return True


def decode_record_meta(payload_b64: str, cipher: Cipher = None
                       ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(uri, inputs, meta): the record's uri, its tensors and its side
    channel (``{}`` when absent). An Arrow record (the reference client's
    ``{"uri", "data"}``) decodes through ``decode_arrow_inputs``, or to
    ``{"data": UnsupportedInput("arrow", "pyarrow")}`` on a host without
    pyarrow; an image entry decodes to :class:`ImageBytes`."""
    obj = _unwrap(payload_b64, cipher)
    if "data" in obj and "inputs" not in obj:
        # reference-client record shape: {"uri", "data": b64(arrow)}
        # (ref client.py:144-147 enqueue); no side channel
        if not _has_pyarrow():
            return obj["uri"], {"data": UnsupportedInput("arrow",
                                                         "pyarrow")}, {}
        return obj["uri"], decode_arrow_inputs(obj["data"]), {}
    meta = obj.get("trace")
    return (obj["uri"],
            {k: decode_tensor(v) for k, v in obj["inputs"].items()},
            meta if isinstance(meta, dict) else {})


def decode_record(payload_b64: str, cipher: Cipher = None
                  ) -> Tuple[str, Dict[str, Any]]:
    uri, inputs, _ = decode_record_meta(payload_b64, cipher)
    return uri, inputs


# ------------------------- reference Arrow wire encoding ----------------
# The reference client serializes records as one Arrow RecordBatch stream,
# b64-wrapped (ref pyzoo/zoo/serving/client.py:149 data_to_b64): a dense
# tensor is a struct{indiceData:list<i32>, indiceShape:list<i32>,
# data:list<f32>, shape:list<i32>} column of 4 one-field rows; a string
# column is either b64 image bytes or '|'-joined string values.

def encode_record_arrow(uri: str, inputs: Dict[str, Any],
                        cipher: Cipher = None) -> str:
    import pyarrow as pa
    fields, arrays = [], []
    for key, value in inputs.items():
        if isinstance(value, ImageBytes):
            fields.append(pa.field(key, pa.string()))
            arrays.append(pa.array(
                [base64.b64encode(value.data).decode()]))
            continue
        if isinstance(value, (list, tuple)) and value and \
                isinstance(value[0], str):
            fields.append(pa.field(key, pa.string()))
            arrays.append(pa.array(["|".join(value)]))
            continue
        arr = np.asarray(value)
        if arr.dtype.kind in ("U", "S"):      # string tensor -> '|' join
            fields.append(pa.field(key, pa.string()))
            arrays.append(pa.array(
                ["|".join(str(v) for v in arr.ravel())]))
            continue
        t = pa.struct([pa.field("indiceData", pa.list_(pa.int32())),
                       pa.field("indiceShape", pa.list_(pa.int32())),
                       pa.field("data", pa.list_(pa.float32())),
                       pa.field("shape", pa.list_(pa.int32()))])
        arrays.append(pa.array(
            [{"indiceData": []}, {"indiceShape": []},
             {"data": arr.astype("float32").ravel()},
             {"shape": np.asarray(arr.shape)}], type=t))
        fields.append(pa.field(key, t))
    # string and image columns are 1 row, tensor struct columns 4 (the
    # reference's layout): a RecordBatch needs equal column lengths, so
    # short columns are null-padded; decoders read row 0
    n_rows = max(len(a) for a in arrays)
    arrays = [a if len(a) == n_rows else
              pa.concat_arrays([a, pa.nulls(n_rows - len(a), a.type)])
              for a in arrays]
    sink = pa.BufferOutputStream()
    batch = pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))
    with pa.RecordBatchStreamWriter(sink, batch.schema) as w:
        w.write_batch(batch)
    arrow_b64 = base64.b64encode(sink.getvalue().to_pybytes()).decode()
    return _wrap({"uri": uri, "data": arrow_b64}, cipher)


# strong magics only: a '|'-joined string tensor that happens to be valid
# b64 must not be misread as an image
_IMAGE_MAGIC = (b"\xff\xd8\xff", b"\x89PNG\r\n\x1a\n",
                b"GIF87a", b"GIF89a", b"II*\x00", b"MM\x00*")


def _looks_like_image(raw: bytes) -> bool:
    if raw.startswith(_IMAGE_MAGIC):
        return True
    return raw[:4] == b"RIFF" and raw[8:12] == b"WEBP"


def decode_arrow_inputs(arrow_b64: str) -> Dict[str, Any]:
    import pyarrow as pa
    buf = base64.b64decode(arrow_b64)
    with pa.ipc.open_stream(pa.py_buffer(buf)) as reader:
        batch = reader.read_next_batch()
    out: Dict[str, Any] = {}
    for name, col in zip(batch.schema.names, batch.columns):
        if pa.types.is_string(col.type):
            s = col[0].as_py()
            try:
                raw = base64.b64decode(s, validate=True)
            except ValueError:
                raw = None
            if raw is not None and _looks_like_image(raw):
                out[name] = ImageBytes(raw)       # ref encode_image
            else:
                out[name] = np.asarray(s.split("|"))
            continue
        rows = col.to_pylist()                    # 4 one-field rows
        merged: Dict[str, Any] = {}
        for row in rows:
            for k, v in (row or {}).items():
                if v not in (None, []):
                    merged.setdefault(k, v)
        data = np.asarray(merged.get("data", []), np.float32)
        shape = [int(v) for v in merged.get("shape", [])]
        if merged.get("indiceData"):
            # sparse: indices [nnz, ndim] + values + dense shape
            idx = np.asarray(merged["indiceData"], np.int64).reshape(
                [int(v) for v in merged["indiceShape"]])
            dense = np.zeros(shape, np.float32)
            dense[tuple(idx.T)] = data
            out[name] = dense
        else:
            out[name] = data.reshape(shape)
    return out


def encode_result(arr: np.ndarray, cipher: Cipher = None) -> str:
    return _wrap(encode_tensor(np.asarray(arr)), cipher)


def encode_error(message: str, cipher: Cipher = None,
                 code: Optional[str] = None) -> str:
    """``code`` types the error for the decoding client: ``"expired"``
    marks a deadline-expired record and decodes into
    :class:`DeadlineExpiredError` instead of plain :class:`ServingError`."""
    obj: Dict[str, Any] = {"error": str(message)[:2000]}
    if code:
        obj["code"] = code
    return _wrap(obj, cipher)


def decode_result(payload_b64: str, cipher: Cipher = None) -> np.ndarray:
    obj = _unwrap(payload_b64, cipher)
    if "error" in obj:
        if obj.get("code") == "expired":
            raise DeadlineExpiredError(obj["error"])
        raise ServingError(obj["error"])
    return decode_tensor(obj)
