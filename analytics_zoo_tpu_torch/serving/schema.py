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
runs its preprocessing chain. The reference client's Arrow records
(ROADMAP A11) decode into an :class:`UnsupportedInput` marker, so the
engine answers them with a typed error result instead of dropping them.
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
    """An input the port does not decode yet: ``kind`` is ``"arrow"``
    (the reference client's Arrow record, ROADMAP A11)."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind

    def __repr__(self) -> str:
        return f"UnsupportedInput({self.kind!r})"


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


def decode_record_meta(payload_b64: str, cipher: Cipher = None
                       ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(uri, inputs, meta): the record's uri, its tensors and its side
    channel (``{}`` when absent). An Arrow record (the reference client's
    ``{"uri", "data"}``) decodes to ``{"data": UnsupportedInput("arrow")}``
    and an image entry to :class:`ImageBytes`."""
    obj = _unwrap(payload_b64, cipher)
    if "data" in obj and "inputs" not in obj:
        return obj["uri"], {"data": UnsupportedInput("arrow")}, {}
    meta = obj.get("trace")
    return (obj["uri"],
            {k: decode_tensor(v) for k, v in obj["inputs"].items()},
            meta if isinstance(meta, dict) else {})


def decode_record(payload_b64: str, cipher: Cipher = None
                  ) -> Tuple[str, Dict[str, Any]]:
    uri, inputs, _ = decode_record_meta(payload_b64, cipher)
    return uri, inputs


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
