"""Serving wire format — how tensors travel through the data plane.

The port's own copy of ``analytics_zoo_tpu/serving/schema.py``, trimmed
to what this slice uses. A record is one JSON object — ``{"uri",
"inputs": {name: tensor}}`` — where each tensor carries dtype/shape plus
b64 raw bytes (C-order), the whole record b64-wrapped for the line
protocol. Records and results are byte-compatible with the JAX package's.
Optional record encryption plugs in as an (encrypt, decrypt) byte-callable
pair. Images, priority lanes, deadlines, generate requests and the Arrow
format wait for later slices.
"""

from __future__ import annotations

import base64
import json
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np

Cipher = Optional[Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]]

# uris become fields of the space/newline-delimited broker protocol: a
# permissive uri would corrupt the framing (or inject commands), so the
# charset is locked down at the schema boundary.
_URI_RE = re.compile(r"^[A-Za-z0-9._:-]{1,256}$")


class ServingError(RuntimeError):
    """An error result stored in place of a prediction."""


def validate_uri(uri: str) -> str:
    if not _URI_RE.match(uri or ""):
        raise ValueError(
            f"bad uri {uri!r}: use 1-256 chars of [A-Za-z0-9._:-]")
    return uri


def encode_tensor(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode()}


def decode_tensor(obj: dict) -> np.ndarray:
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
                  cipher: Cipher = None) -> str:
    return _wrap({"uri": uri,
                  "inputs": {k: encode_tensor(np.asarray(v))
                             for k, v in inputs.items()}}, cipher)


def decode_record(payload_b64: str, cipher: Cipher = None
                  ) -> Tuple[str, Dict[str, np.ndarray]]:
    """(uri, inputs). A record's other fields (the JAX client's trace
    stamp) are ignored."""
    obj = _unwrap(payload_b64, cipher)
    return obj["uri"], {k: decode_tensor(v)
                        for k, v in obj["inputs"].items()}


def encode_result(arr: np.ndarray, cipher: Cipher = None) -> str:
    return _wrap(encode_tensor(np.asarray(arr)), cipher)


def encode_error(message: str, cipher: Cipher = None) -> str:
    return _wrap({"error": str(message)[:2000]}, cipher)


def decode_result(payload_b64: str, cipher: Cipher = None) -> np.ndarray:
    obj = _unwrap(payload_b64, cipher)
    if "error" in obj:
        raise ServingError(obj["error"])
    return decode_tensor(obj)
